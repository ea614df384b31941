"""Client-side SecAgg session — the worker's half of the Bonawitz rounds
(:mod:`pygrid_tpu_torch.federated.secagg` math, ``federated/secagg_service.py``
server state): the port's counterpart of :mod:`pygrid_tpu.client.secagg`.

Usage::

    client = FLClient(node_url, device="cuda")
    auth = client.authenticate(name, version)
    cyc = client.cycle_request(auth["worker_id"], name, version, ...)
    session = SecAggSession(client, auth["worker_id"], cyc["request_key"])
    session.advertise()
    session.wait_roster()
    session.upload_shares()
    session.wait_masking()
    ...train locally on the card → diffs...
    session.report(diffs)            # masked — the node never sees them
    session.finish()                 # answers the unmask round, polls DONE

Every value the session sends the server is either public (DH public
key), sealed to a peer (share bundles), masked (the report), or — in the
unmask round — exactly the Bonawitz-sanctioned reveals: Shamir shares of
survivors' self-mask seeds and of *dropouts'* DH secrets. ``finish``
refuses to reveal an sk share for any worker the session saw survive.

A worker's diffs may be torch tensors on its device: they cross to the
host once and are quantised and masked there as numpy arrays are, so the
masked blob is byte for byte the JAX package's for the same seeds and
keys.
"""

from __future__ import annotations

import json
import secrets
import time
from typing import Any, Sequence

import numpy as np
import torch

from pygrid_tpu_torch.federated import secagg
from pygrid_tpu_torch.utils.codes import CYCLE, MODEL_CENTRIC_FL_EVENTS, MSG_FIELD
from pygrid_tpu_torch.utils.exceptions import PyGridError


class SecAggRefusal(PyGridError):
    """The session refused to reveal material (e.g. the server claimed a
    worker dropped whose report this session saw acknowledged). Never
    swallowed — this is the client-side half of the privacy guarantee."""


def _host(d: Any) -> np.ndarray:
    if isinstance(d, torch.Tensor):
        return d.detach().cpu().numpy()
    return np.asarray(d)


class SecAggSession:
    def __init__(
        self,
        fl_client,
        worker_id: str,
        request_key: str,
        client_config: dict | None = None,
    ) -> None:
        """``client_config`` is the hosted process's client config (from
        the cycle-request response) — pass it so ``local_dp`` applies to
        reports; SecAgg masks whatever it is given, and client-side DP
        is the only DP that composes with it."""
        self.client = fl_client
        self.worker_id = worker_id
        self.request_key = request_key
        self.client_config = client_config or {}
        self.keypair = secagg.DHKeyPair.generate()
        self.self_seed = secrets.token_bytes(16)
        self.roster: dict[str, int] = {}
        self.threshold = 0
        self.clip_range = 0.0
        self.mask_set: list[str] = []
        self.pair_secrets: dict[str, bytes] = {}
        self._own_shares: dict[str, tuple[int, int]] = {}
        self._bundle_in: dict[str, str] = {}
        self._reported_survivors: set[str] = set()

    # ── transport ────────────────────────────────────────────────────────────

    def _send(self, msg_type: str, **fields) -> dict:
        data = {
            MSG_FIELD.WORKER_ID: self.worker_id,
            CYCLE.KEY: self.request_key,
            **fields,
        }
        response = self.client._send_event(msg_type, data)
        payload = response.get(MSG_FIELD.DATA, response)
        if isinstance(payload, dict) and payload.get("error"):
            raise PyGridError(payload["error"])
        return payload

    # ── round 0: keys ────────────────────────────────────────────────────────

    def advertise(self) -> dict:
        return self._send(
            MODEL_CENTRIC_FL_EVENTS.SECAGG_ADVERTISE,
            public_key=secagg.int_to_hex(self.keypair.public),
        )

    def wait_roster(self, timeout: float = 30.0, interval: float = 0.05) -> dict:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            out = self._send(MODEL_CENTRIC_FL_EVENTS.SECAGG_ROSTER)
            if out.get("status") == "ready":
                self.roster = {
                    wid: secagg.hex_to_int(pub)
                    for wid, pub in out["roster"].items()
                }
                self.threshold = int(out["threshold"])
                if self.threshold <= len(self.roster) // 2:
                    # a sub-majority threshold would let a malicious server
                    # play disjoint t-quorums against each other to unmask
                    # an individual report — refuse to participate
                    raise SecAggRefusal(
                        f"server sent sub-majority secagg threshold "
                        f"{self.threshold} for roster of {len(self.roster)}"
                    )
                self.clip_range = float(out["clip_range"])
                for wid, pub in self.roster.items():
                    if wid != self.worker_id:
                        self.pair_secrets[wid] = secagg.dh_shared_secret(
                            self.keypair.secret, pub
                        )
                return out
            time.sleep(interval)
        raise PyGridError("secagg roster wait timed out")

    # ── round 1: share bundles ───────────────────────────────────────────────

    def _index_of(self, wid: str) -> int:
        return sorted(self.roster).index(wid) + 1

    def upload_shares(self) -> dict:
        if not self.roster:
            raise PyGridError("wait_roster first")
        n, t = len(self.roster), self.threshold
        b_int = int.from_bytes(self.self_seed, "big")
        b_points = secagg.shamir_share(b_int, n, t)
        sk_points = secagg.shamir_share(self.keypair.secret, n, t)
        sealed: dict[str, str] = {}
        for wid in self.roster:
            x = self._index_of(wid)
            b_y = next(y for px, y in b_points if px == x)
            sk_y = next(y for px, y in sk_points if px == x)
            if wid == self.worker_id:
                self._own_shares["b"] = (x, b_y)
                self._own_shares["sk"] = (x, sk_y)
                continue
            plaintext = json.dumps(
                {
                    "x": x,
                    "b": secagg.int_to_hex(b_y),
                    "sk": secagg.int_to_hex(sk_y),
                }
            ).encode()
            key = secagg.kdf(self.pair_secrets[wid], "share-transport")
            sealed[wid] = secagg.seal(key, plaintext).hex()
        return self._send(
            MODEL_CENTRIC_FL_EVENTS.SECAGG_SHARES, shares=sealed
        )

    def wait_masking(self, timeout: float = 30.0, interval: float = 0.05) -> dict:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            out = self._send(MODEL_CENTRIC_FL_EVENTS.SECAGG_STATUS)
            if out.get("phase") in ("masking", "unmasking"):
                self.mask_set = list(out["mask_set"])
                self._bundle_in = dict(out.get("bundle") or {})
                if self.worker_id not in self.mask_set:
                    raise PyGridError("this worker missed the mask set")
                return out
            if out.get("phase") == "failed":
                raise PyGridError("secagg cycle failed before masking")
            time.sleep(interval)
        raise PyGridError("secagg masking wait timed out")

    # ── round 2: masked report ───────────────────────────────────────────────

    def masked_blob(self, diffs: Sequence[Any]) -> bytes:
        """The masked envelope of ``diffs`` (numpy arrays or tensors on
        any device)."""
        if not self.mask_set:
            raise PyGridError("wait_masking first")
        diffs = [_host(d) for d in diffs]
        local_dp = self.client_config.get("local_dp")
        if local_dp:
            # clip + noise BEFORE quantize/mask: the only DP that
            # composes with secure aggregation is the client-side kind
            from pygrid_tpu_torch.federated.privacy import local_dp_noise

            diffs = local_dp_noise(
                diffs,
                float(local_dp["clip_norm"]),
                float(local_dp.get("noise_multiplier", 0.0)),
            )
        quantized = secagg.quantize(diffs, self.clip_range, len(self.mask_set))
        masked = secagg.mask_quantized(
            quantized,
            self.worker_id,
            self.self_seed,
            {
                wid: self.pair_secrets[wid]
                for wid in self.mask_set
                if wid != self.worker_id
            },
        )
        return secagg.encode_masked_diff(masked)

    def report(self, diffs: Sequence[Any]) -> dict:
        out = self.client.report(
            self.worker_id, self.request_key, self.masked_blob(diffs)
        )
        if isinstance(out, dict) and out.get("error"):
            raise PyGridError(out["error"])
        self._reported_survivors.add(self.worker_id)
        return out

    # ── round 3: unmask ──────────────────────────────────────────────────────

    def _decrypt_share(self, from_wid: str) -> dict:
        blob = bytes.fromhex(self._bundle_in[from_wid])
        key = secagg.kdf(self.pair_secrets[from_wid], "share-transport")
        return json.loads(secagg.open_sealed(key, blob).decode())

    def answer_unmask(self, survivors: list[str], dropouts: list[str]) -> dict:
        # refuse to reveal sk material for anyone this session saw report —
        # the client-side half of the double-masking guarantee
        bad = set(dropouts) & self._reported_survivors
        if bad:
            raise SecAggRefusal(
                f"server claims {sorted(bad)} dropped but their reports "
                "were acknowledged — refusing to unmask"
            )
        b_shares: dict[str, tuple[int, str]] = {}
        sk_shares: dict[str, tuple[int, str]] = {}
        for wid in survivors:
            if wid == self.worker_id:
                x, y = self._own_shares["b"]
                b_shares[wid] = (x, secagg.int_to_hex(y))
            elif wid in self._bundle_in:
                entry = self._decrypt_share(wid)
                b_shares[wid] = (int(entry["x"]), entry["b"])
        for wid in dropouts:
            if wid in self._bundle_in:
                entry = self._decrypt_share(wid)
                sk_shares[wid] = (int(entry["x"]), entry["sk"])
        return self._send(
            MODEL_CENTRIC_FL_EVENTS.SECAGG_UNMASK,
            b_shares=b_shares,
            sk_shares=sk_shares,
        )

    def finish(self, timeout: float = 60.0, interval: float = 0.1) -> str:
        """Poll until the cycle resolves, answering the unmask round when
        it opens. Returns the terminal phase: "done"/"failed" if observed
        live, else "closed" once the cycle record completes (either way)
        and the per-cycle state is dropped."""
        answered = False
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                out = self._send(MODEL_CENTRIC_FL_EVENTS.SECAGG_STATUS)
            except PyGridError:
                # cycle completed: its worker-cycle row no longer resolves
                return "closed"
            phase = out.get("phase")
            if phase == "unmasking" and not answered:
                try:
                    self.answer_unmask(
                        list(out.get("survivors") or []),
                        list(out.get("dropouts") or []),
                    )
                except SecAggRefusal:
                    raise
                except PyGridError:
                    # another survivor's shares met the quorum between our
                    # status poll and this submission, and the cycle closed
                    # — the round succeeded without us
                    return "closed"
                answered = True
            elif phase in ("done", "failed"):
                return phase
            elif phase == "none":
                # per-cycle state already dropped (quorum resolved between
                # our polls) — terminal, same as the closed-cycle path
                return "closed"
            time.sleep(interval)
        raise PyGridError("secagg finish timed out")
