"""Port parity: pygrid_tpu_torch.utils (codes, exceptions, passwords,
metrics) against pygrid_tpu.utils, one to one.

The wire constants and the error names and default messages are part of
the observable surface (they reach clients as event types and as
``{"error": str(e)}``), so every constant class, constant and error class
of the JAX package must exist in the port with the same value; a password
hashed by either package verifies in the other; the Prometheus exposition
renders the same text.
"""

import inspect
import math

import pytest

from pygrid_tpu.utils import codes as jcodes
from pygrid_tpu.utils import exceptions as jexc
from pygrid_tpu.utils import metrics as jmetrics
from pygrid_tpu.utils import passwords as jpw
from pygrid_tpu_torch.utils import codes, exceptions, metrics, passwords


def _constant_classes(mod):
    return {n: c for n, c in vars(mod).items()
            if inspect.isclass(c) and c.__module__ == mod.__name__}


def test_codes_match_one_to_one():
    ref, port = _constant_classes(jcodes), _constant_classes(codes)
    assert set(port) == set(ref)
    for name, cls in ref.items():
        want = {k: v for k, v in vars(cls).items() if not k.startswith("_")}
        got = {k: v for k, v in vars(port[name]).items() if not k.startswith("_")}
        assert got == want, name
    plain = {k: v for k, v in vars(jcodes).items()
             if not k.startswith("_") and not inspect.isclass(v) and not inspect.ismodule(v)}
    assert {k: getattr(codes, k) for k in plain} == plain


#: errors only the port raises: a CUDA device asked for and not there (the
#: reference picks whatever platform jax has)
PORT_ONLY_ERRORS = {"DeviceUnavailableError"}


def test_exceptions_match_one_to_one():
    ref = {n: c for n, c in vars(jexc).items()
           if inspect.isclass(c) and issubclass(c, BaseException)}
    port = {n: c for n, c in vars(exceptions).items()
            if inspect.isclass(c) and issubclass(c, BaseException)}
    assert set(port) == set(ref) | PORT_ONLY_ERRORS
    for name in PORT_ONLY_ERRORS:
        assert issubclass(port[name], exceptions.PyGridError)
        assert issubclass(port[name], RuntimeError)
    for name, cls in ref.items():
        assert [b.__name__ for b in port[name].__mro__] == [b.__name__ for b in cls.__mro__]
        if name == "EmptyCryptoPrimitiveStoreError":
            e, je = port[name]({"op": "mul"}), cls({"op": "mul"})
            assert e.kwargs_ == je.kwargs_
        else:
            e, je = port[name](), cls()
            assert str(port[name]("custom")) == str(cls("custom"))
        assert str(e) == str(je), name


@pytest.mark.parametrize("password", ["admin", "", "pässwörd ✓", "x" * 200])
def test_password_hashed_in_one_package_verifies_in_the_other(password):
    salt, digest = passwords.hash_password(password)
    assert jpw.verify_password(password, salt, digest)
    assert not jpw.verify_password(password + "!", salt, digest)
    jsalt, jdigest = jpw.hash_password(password)
    assert passwords.verify_password(password, jsalt, jdigest)
    assert not passwords.verify_password(password + "!", jsalt, jdigest)
    assert passwords.pbkdf2(password, jsalt) == jpw.pbkdf2(password, jsalt)


def test_exposition_renders_the_same_text():
    def fill(mod):
        exp = mod.Exposition(prefix="pygrid")
        exp.gauge("up", 1, "node up")
        exp.counter("reqs_total", 7, "requests", {"route": 'a"b\\c\nd'})
        exp.gauge("up", 0, "node up", {"node": "x"})
        exp.histogram("lat_seconds", {"buckets": [(0.1, 1), (1.0, 3), (math.inf, 4)],
                                      "sum": 2.5, "count": 4}, "latency", {"op": "fit"})
        exp.sample("weird", 1e-9, "tiny", type_="untyped")
        return exp.render()

    assert fill(metrics) == fill(jmetrics)
    assert metrics._fmt(-math.inf) == jmetrics._fmt(-math.inf) == "-Inf"
