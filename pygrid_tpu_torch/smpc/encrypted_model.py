"""End-to-end encrypted inference across the grid — the reference's flagship
privacy flow (SURVEY §3.5): the port's counterpart of
:mod:`pygrid_tpu.smpc.encrypted_model`.

1. **Publish** — a model owner fix-prec-shares each weight over share-holder
   workers (one int64 share per worker, a crypto-provider worker for Beaver
   triples) and serves the inference Plan with ``mpc=True``; the served
   plan's State carries :class:`SharedTensorRef` wiring metadata (owners,
   share ids, encoder, provider) but **no share material**.
2. **Discover** — a data scientist asks the Network
   ``/search-encrypted-model`` (reference
   ``apps/network/src/app/routes/network.py:157-198``), which fans out to
   every node's ``/data-centric/search-encrypted-models`` (share-holder walk,
   reference ``routes/data_centric/routes.py:192-250``) and answers with the
   share-holders, the crypto provider and their grid addresses
   (:meth:`EncryptedModel.discover`).
3. **Predict** — the client shares its input over the same holders, then
   runs the Plan's portable op-list where every value is a
   :class:`~pygrid_tpu_torch.smpc.remote.RemoteSharedTensor`: linear ops are
   share-local pointer ops, every matmul/mul is a cross-worker Beaver round
   dealt by the provider (reference inference entry
   ``events/data_centric/model_events.py:21-129``), and the prediction is
   reconstructed client-side — no single worker ever holds the model
   weights, the input, or the output in the clear.

The op-list is the JAX package's portable dialect: a plan built by the JAX
package runs here as it does there, and so does one built by the port
(:meth:`Plan.build` lowers its graph to the same list). A plan without an
op-list makes :meth:`EncryptedModel.predict` raise ``PlanInvalidError``;
its ``torch_blob`` is never run. Discovery goes through the port's network
(:mod:`pygrid_tpu_torch.network`) or the JAX package's — they answer the
same JSON — over :mod:`pygrid_tpu_torch.web.client`.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from pygrid_tpu_torch.serde import register_serde
from pygrid_tpu_torch.smpc.fixed import FixedPointEncoder
from pygrid_tpu_torch.smpc.remote import (
    RemoteCryptoProvider,
    RemoteSharedTensor,
    fix_prec_share_to_nodes,
)
from pygrid_tpu_torch.utils.exceptions import PlanInvalidError, PyGridError


@register_serde(name="pygrid.SharedTensorRef")
class SharedTensorRef:
    """Where a state tensor's additive shares live: owners (worker ids), the
    share object id at each owner, shape, fixed-point encoder params, and
    the crypto-provider id. This is what a served encrypted Plan's State
    carries across the wire — discovery metadata and wiring, zero secrets.
    Duck-typed like AdditiveSharingTensor (``owners``/``crypto_provider_id``)
    so a node's share-holder walk reports it."""

    def __init__(
        self,
        owners: Sequence[str],
        share_ids: Sequence[int],
        shape: Sequence[int],
        base: int,
        precision_fractional: int,
        crypto_provider_id: str | None,
    ) -> None:
        self.owners = tuple(owners)
        self.share_ids = tuple(share_ids)
        self.shape = tuple(int(s) for s in shape)
        self.base = base
        self.precision_fractional = precision_fractional
        self.crypto_provider_id = crypto_provider_id

    def _bufferize(self) -> dict:
        return {
            "owners": list(self.owners),
            "share_ids": list(self.share_ids),
            "shape": list(self.shape),
            "base": self.base,
            "precision_fractional": self.precision_fractional,
            "crypto_provider_id": self.crypto_provider_id,
        }

    @classmethod
    def _unbufferize(cls, data: dict) -> "SharedTensorRef":
        return cls(
            data["owners"],
            data["share_ids"],
            data["shape"],
            data["base"],
            data["precision_fractional"],
            data["crypto_provider_id"],
        )

    def __repr__(self) -> str:
        return (
            f"SharedTensorRef(owners={self.owners}, shape={self.shape}, "
            f"provider={self.crypto_provider_id!r})"
        )


def publish_encrypted_model(
    plan: Any,
    model_id: str,
    host_client: Any,
    holder_clients: Sequence[Any],
    provider_client: Any,
    weights: Sequence[Any],
    base: int = 10,
    precision_fractional: int = 3,
    generator: torch.Generator | None = None,
    device: str | torch.device = "cuda",
) -> list[RemoteSharedTensor]:
    """Share ``weights`` over the holder workers (drawn on ``device``, from
    ``generator``) and serve ``plan`` on the hosting node with ``mpc=True``
    + ``allow_download=True`` (the plan blob a client downloads carries only
    the op-list and SharedTensorRefs).

    Duck-typed over the clients: the provider is dialed into every holder
    first with ``provider_client.connect_nodes(holder)`` so Beaver rounds
    can deal shares over its mesh (reference ``connect_grid_nodes``,
    control_events.py:44-54), and the plan is served with
    ``host_client.serve_model(plan, model_id, mpc=True, allow_download=True)``."""
    from pygrid_tpu_torch.plans.state import State

    for holder in holder_clients:
        provider_client.connect_nodes(holder)
    provider = RemoteCryptoProvider(provider_client)

    shared: list[RemoteSharedTensor] = []
    refs: list[SharedTensorRef] = []
    for i, w in enumerate(weights):
        st = fix_prec_share_to_nodes(
            np.asarray(w),
            holder_clients,
            base=base,
            precision_fractional=precision_fractional,
            tags=(f"#emodel:{model_id}:state:{i}",),
            crypto_provider=provider,
            generator=generator,
            device=device,
        )
        shared.append(st)
        refs.append(
            SharedTensorRef(
                owners=[getattr(c, "id", "") for c in holder_clients],
                share_ids=[p.id_at_location for p in st.pointers],
                shape=np.shape(w),
                base=base,
                precision_fractional=precision_fractional,
                crypto_provider_id=provider.id,
            )
        )
    plan.state = State.from_tensors(refs)
    resp = host_client.serve_model(
        plan, model_id, mpc=True, allow_download=True
    )
    if not resp.get("success", True):
        raise PyGridError(str(resp))
    return shared


# --- the SMPC op-list interpreter -------------------------------------------
#
# Runs a Plan's portable op-list (plans/translators.py dialect) where values
# are RemoteSharedTensors. Linear structure ops are share-local; mul/matmul
# are cross-worker Beaver rounds. The vocabulary covers SMPC-friendly
# inference graphs (affine layers + polynomial activations — the CryptoNets
# family); data-dependent nonlinearities (relu/max) need comparison
# protocols and are rejected explicitly rather than silently miscomputed.
# Public (unshared) values are host numpy arrays, as in the reference.


def _shared_reshape(t: RemoteSharedTensor, shape: tuple) -> RemoteSharedTensor:
    return t._like([p.remote_op("reshape", *shape) for p in t.pointers])


def _broadcast_in_dim(t, params) -> Any:
    """Materialize the broadcast share-locally (linear: broadcasting each
    additive share broadcasts the secret): insert size-1 axes per
    broadcast_dimensions, then remote ``broadcast_to`` the full shape."""
    shape = tuple(int(s) for s in params["shape"])
    bdims = tuple(int(d) for d in params["broadcast_dimensions"])
    in_shape = t.shape if isinstance(t, RemoteSharedTensor) else np.shape(t)
    aligned = [1] * len(shape)
    for in_ax, out_ax in enumerate(bdims):
        aligned[out_ax] = in_shape[in_ax]
    if isinstance(t, RemoteSharedTensor):
        aligned_t = _shared_reshape(t, tuple(aligned))
        return aligned_t._like([
            p.remote_op("broadcast_to", shape=list(shape))
            for p in aligned_t.pointers
        ])
    return np.broadcast_to(np.reshape(t, aligned), shape)


def _dot_general(a, b, params):
    dnums = params["dimension_numbers"]
    contract = tuple(tuple(int(x) for x in d) for d in dnums[0])
    batch = tuple(tuple(int(x) for x in d) for d in dnums[1])
    plain_matmul = (
        contract == ((1,), (0,)) and batch == ((), ())
    )
    if not plain_matmul:
        raise PyGridError(
            f"encrypted dot_general supports plain 2D matmul only, got "
            f"dimension_numbers={dnums}"
        )
    if isinstance(a, RemoteSharedTensor) and isinstance(b, RemoteSharedTensor):
        return a @ b
    raise PyGridError(
        "encrypted matmul needs both operands shared — share the public side"
    )


def _elementwise(name: str, shared: Callable, public: Callable) -> Callable:
    """A binary op over two shared operands (share-local or Beaver) or two
    public ones (numpy); a mix is rejected."""

    def run(a, b, params):
        if isinstance(a, RemoteSharedTensor) and isinstance(b, RemoteSharedTensor):
            return shared(a, b)
        if not isinstance(a, RemoteSharedTensor) and not isinstance(
            b, RemoteSharedTensor
        ):
            return public(a, b)
        raise PyGridError(f"encrypted {name} needs both operands shared")

    return run


_add = _elementwise("add", lambda a, b: a + b, np.add)


_SMPC_OPS: dict[str, Callable] = {
    "dot_general": _dot_general,
    "add": _add,
    "add_any": _add,
    "sub": _elementwise("sub", lambda a, b: a - b, np.subtract),
    "mul": _elementwise("mul", lambda a, b: a * b, np.multiply),
    "broadcast_in_dim": lambda a, p: _broadcast_in_dim(a, p),
    "reshape": lambda a, p: _shared_reshape(
        a, tuple(int(s) for s in p["new_sizes"])
    )
    if isinstance(a, RemoteSharedTensor)
    else np.reshape(a, tuple(int(s) for s in p["new_sizes"])),
    # the reference's lowering, kept as it is: a shared operand's transpose
    # is a remote ``t`` (the last two axes swapped) whatever the permutation
    "transpose": lambda a, p: a._like([q.remote_op("t") for q in a.pointers])
    if isinstance(a, RemoteSharedTensor)
    else np.transpose(a, [int(x) for x in p["permutation"]]),
    # dtype bookkeeping from the float trace — shares are already ring
    # integers, nothing to convert
    "convert_element_type": lambda a, p: a,
}


def run_encrypted_oplist(oplist: dict, args: Sequence[Any]) -> Any:
    """Interpret a Plan op-list over RemoteSharedTensor/ndarray values."""
    env: dict[int, Any] = {}

    def read(ref):
        if "lit" in ref:
            return ref["lit"]
        if "lit_arr" in ref:
            return ref["lit_arr"]
        return env[ref["var"]]

    for cid, cval in zip(oplist["constvars"], oplist["consts"]):
        env[cid] = cval
    if len(args) != len(oplist["invars"]):
        raise PyGridError(
            f"plan expects {len(oplist['invars'])} inputs, got {len(args)}"
        )
    for iid, a in zip(oplist["invars"], args):
        env[iid] = a
    from pygrid_tpu_torch.plans.translators import _CALL_OPS

    for eqn in oplist["eqns"]:
        invals = [read(r) for r in eqn["in"]]
        if eqn["op"] in _CALL_OPS:
            # jit/pjit wrapper: recurse into the inner jaxpr (same unwrap
            # as the plaintext interpreter, translators.py run_oplist)
            inner = None
            for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                cand = eqn["params"].get(key)
                if isinstance(cand, dict) and "__jaxpr__" in cand:
                    inner = cand["__jaxpr__"]
                    break
            if inner is None:
                raise PyGridError(f"no inner jaxpr for {eqn['op']!r}")
            out = run_encrypted_oplist(inner, invals)
            outs = out if isinstance(out, (list, tuple)) else [out]
        else:
            fn = _SMPC_OPS.get(eqn["op"])
            if fn is None:
                raise PyGridError(
                    f"op {eqn['op']!r} has no SMPC lowering (data-dependent "
                    "nonlinearities need comparison protocols; use polynomial "
                    "activations for encrypted inference)"
                )
            out = fn(*invals, eqn["params"])
            outs = out if isinstance(out, (list, tuple)) else [out]
        for oid, o in zip(eqn["out"], outs):
            env[oid] = o
    results = [read(r) for r in oplist["outvars"]]
    return results[0] if len(results) == 1 else results


# --- the data-scientist side -------------------------------------------------


class EncryptedModel:
    """Client handle to an encrypted model: its plan, the weights' shared
    handles, the share-holders and the provider — wired by hand or found
    through a Network (:meth:`discover`). The client's opened values
    (Beaver's d and e, the prediction) live on ``device`` (default
    ``"cuda"``)."""

    def __init__(
        self,
        plan: Any,
        weights: list[RemoteSharedTensor],
        holder_clients: list[Any],
        provider: RemoteCryptoProvider,
        encoder: FixedPointEncoder,
        device: str | torch.device = "cuda",
        all_clients: list[Any] | None = None,
    ) -> None:
        self.plan = plan
        self.weights = weights
        self.holder_clients = holder_clients
        self.provider = provider
        self.encoder = encoder
        self.device = device
        # every client discover() dialed (host included) — close() must
        # release them all, not just holders/provider
        self._all_clients = (
            list(all_clients)
            if all_clients is not None
            else holder_clients + [provider.location]
        )

    @classmethod
    def discover(
        cls,
        network_url: str,
        model_id: str,
        client_factory: Callable[[str], Any] | None = None,
        timeout: float = 30.0,
        device: str | torch.device = "cuda",
    ) -> "EncryptedModel":
        """Search the grid for ``model_id``'s share-holders, connect to
        them, download the plan from the hosting node, and wire up
        RemoteSharedTensor handles from its SharedTensorRefs. The clients
        are ``client_factory(address)``, by default the port's
        :class:`~pygrid_tpu_torch.client.DataCentricFLClient` on ``device``
        (default ``"cuda"``; without a GPU that raises unless
        ``device="cpu"``)."""
        from pygrid_tpu_torch.client.data_centric import DataCentricFLClient
        from pygrid_tpu_torch.device import resolve
        from pygrid_tpu_torch.runtime.pointers import PointerTensor
        from pygrid_tpu_torch.web import client as http

        dev = resolve(device)
        factory = client_factory or (
            lambda addr: DataCentricFLClient(addr, timeout=timeout, device=dev)
        )
        # 1. search the network
        resp = http.post(
            network_url.rstrip("/") + "/search-encrypted-model",
            json={"model_id": model_id},
            timeout=timeout,
        )
        if resp.status_code != 200:
            raise PyGridError(
                f"encrypted-model search failed ({resp.status_code}): "
                f"{resp.text[:200]}"
            )
        match = resp.json().get("match-nodes") or {}
        if not match:
            raise PyGridError(f"no node hosts encrypted model {model_id!r}")
        host_id, info = next(iter(match.items()))
        worker_ids = info["nodes"]["workers"]
        provider_ids = info["nodes"]["crypto_provider"]
        if not provider_ids:
            raise PyGridError(
                f"model {model_id!r} has no crypto provider — its shares "
                "were placed without one, so Beaver rounds cannot be dealt"
            )
        addresses = dict(info.get("worker_addresses") or {})
        addresses.setdefault(host_id, info["address"])
        missing = [
            w for w in worker_ids + provider_ids if w not in addresses
        ]
        if missing:
            raise PyGridError(
                f"no grid address for share-holder(s) {missing}"
            )

        # 2. download the plan from the host
        host = factory(info["address"])
        clients: dict[str, Any] = {host_id: host}
        try:
            plan = host.download_model(model_id)
            refs = [
                t
                for t in (plan.state.tensors() if plan.state else [])
                if isinstance(t, SharedTensorRef)
            ]
            if not refs:
                raise PyGridError(f"model {model_id!r} carries no shared state")

            def client_of(wid: str):
                if wid not in clients:
                    clients[wid] = factory(addresses[wid])
                return clients[wid]

            # 3. dial the holders and the provider; 4. mesh the provider
            # into every holder so it can deal Beaver shares to them
            provider_client = client_of(provider_ids[0])
            holder_clients = [client_of(w) for w in refs[0].owners]
            for holder in holder_clients:
                provider_client.connect_nodes(holder)
            provider = RemoteCryptoProvider(provider_client)
            encoder = FixedPointEncoder(
                refs[0].base, refs[0].precision_fractional
            )
            # 5. the weights: RemoteSharedTensors over the refs' share ids
            weights = [
                RemoteSharedTensor(
                    [
                        PointerTensor(
                            location=client_of(o),
                            id_at_location=sid,
                            shape=ref.shape,
                        )
                        for o, sid in zip(ref.owners, ref.share_ids)
                    ],
                    FixedPointEncoder(ref.base, ref.precision_fractional),
                    provider,
                    dev,
                )
                for ref in refs
            ]
        except BaseException:
            for c in clients.values():
                c.close()
            raise
        return cls(
            plan,
            weights,
            holder_clients,
            provider,
            encoder,
            device=dev,
            all_clients=list(clients.values()),
        )

    def predict(self, x, generator: torch.Generator | None = None) -> np.ndarray:
        """Share the input (drawn from ``generator`` on the model's device),
        run the op-list with cross-worker Beaver rounds, reconstruct the
        prediction client-side."""
        oplist = getattr(self.plan, "oplist", None)
        if oplist is None:
            raise PlanInvalidError(
                "the plan carries no op-list: encrypted inference runs the "
                "plan's portable op-list"
            )
        sx = fix_prec_share_to_nodes(
            np.asarray(x, dtype=np.float32),
            self.holder_clients,
            base=self.encoder.base,
            precision_fractional=self.encoder.precision_fractional,
            crypto_provider=self.provider,
            generator=generator,
            device=self.device,
        )
        out = run_encrypted_oplist(
            oplist["__jaxpr__"] if "__jaxpr__" in oplist else oplist,
            [sx] + list(self.weights),
        )
        if not isinstance(out, RemoteSharedTensor):
            raise PyGridError("encrypted plan did not produce a shared output")
        return out.get()

    def close(self) -> None:
        seen = set()
        for c in self._all_clients:
            if id(c) not in seen:
                seen.add(id(c))
                try:
                    c.close()
                except Exception:  # noqa: BLE001 — teardown
                    pass
