"""Rank side of tests/test_torch_sharded_smpc.py: the party axis of stacked
shares split over a mesh axis of 4 ranks."""

import numpy as np
import torch

from pygrid_tpu_torch.parallel import make_mesh
from pygrid_tpu_torch.smpc import ring as R
from pygrid_tpu_torch.smpc.sharded import (
    deal_triples,
    make_sharded_beaver,
    make_sharded_open,
    sharded_beaver,
)
from torch_world import registry

CASES, case = registry()


def _mesh():
    return make_mesh(4, axes=("parties",), device="cpu")


def _ring(a):
    return R.to_ring(a, device="cpu")


def _key(k):
    return torch.from_numpy(np.asarray(k).astype(np.int64))


@case
def open_adversarial(inp):
    return {"total": R.from_ring(make_sharded_open(_mesh())(_ring(inp["open_vals"])))}


def _beaver(inp, op):
    combine = make_sharded_beaver(_mesh(), op=op)
    names = ("x_sh", "y_sh", "a_sh", "b_sh", "c_sh")
    z = combine(*(_ring(inp[f"{op}_{n}"]) for n in names))
    shape = tuple(inp[f"{op}_x_sh"].shape[2:])
    a, b, c = deal_triples(_key(inp[f"{op}_key"]), shape, shape, 8, op=op, batch=4)
    return {"z": R.from_ring(z), "a": R.from_ring(a), "b": R.from_ring(b), "c": R.from_ring(c)}


@case
def beaver_mul(inp):
    return _beaver(inp, "mul")


@case
def beaver_matmul(inp):
    return _beaver(inp, "matmul")


@case
def deal_unbatched(inp):
    out = {}
    for op, shape in (("mul", (3, 7)), ("matmul", (5, 5))):
        for name, t in zip("abc", deal_triples(_key(inp["deal_key"]), shape, shape, 3, op=op)):
            out[f"{op}_{name}"] = R.from_ring(t)
    return out


@case
def end_to_end(inp):
    mesh = _mesh()
    z = sharded_beaver(mesh, _key(inp["e2e_key"]), _ring(inp["e2e_x_sh"]), _ring(inp["e2e_y_sh"]))
    return {"z": R.from_ring(z), "open": R.from_ring(make_sharded_open(mesh)(z))}


@case
def single_device_mesh(inp):
    # the party axis of size 1: every rank holds all parties, the opens are
    # collectives over a group of one
    mesh = make_mesh(4, axes=("rep", "parties"), shape=(4, 1), device="cpu")
    z = sharded_beaver(mesh, _key(inp["one_key"]), _ring(inp["one_x_sh"]), _ring(inp["one_y_sh"]))
    return {"z": R.from_ring(z), "open": R.from_ring(make_sharded_open(mesh)(z))}


@case
def open_property(inp):
    open_ = make_sharded_open(_mesh())
    return {"totals": np.stack([R.from_ring(open_(_ring(v))) for v in inp["seed_vals"]])}
