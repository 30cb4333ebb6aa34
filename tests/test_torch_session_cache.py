"""A value computed once per test run and shared by pytest-xdist's workers.

Under ``--dist load`` every worker that receives a test of a file builds
that file's ``scope="module"`` fixtures anew. The port's heaviest
fixtures run a JAX reference step op by op for minutes; ``computed_once``
lets the first worker compute such a reference and the others load it.
This is pytest-xdist's documented pattern for a session-wide fixture: a
file lock in the directory the run's workers share
(``tmp_path_factory.getbasetemp().parent``), the value saved there with
numpy (no pickle). Every caller, the computing worker included, gets the
saved copy, bit for bit what was computed, with the same types.

The tests below hold the round trip and the one computation.
"""

import fcntl
import json
import os
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch


def computed_once(tmp_path_factory, name, compute):
    """``compute()`` once per test run, shared by the run's workers.

    The value is a tree of dicts (keys: strings, numbers or None), lists
    and tuples whose leaves are numpy, JAX or torch arrays, Python
    numbers, strings, booleans or None."""
    root = tmp_path_factory.getbasetemp()
    if "PYTEST_XDIST_WORKER" in os.environ:
        root = root.parent  # shared by every worker of this run only
    path = root / f"{name}.npz"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            arrays = []
            tree = _encode(compute(), arrays)
            tmp = root / f"{name}.tmp.npz"
            np.savez(tmp, tree=np.array(json.dumps(tree)),
                     **{f"a{i}": a for i, a in enumerate(arrays)})
            os.replace(tmp, path)
    with np.load(path) as saved:
        return _decode(json.loads(str(saved["tree"])), saved)


def _array(kind, a):
    """An array leaf: its kind, its dtype's name and its data (bfloat16
    as its bits, which numpy's format cannot name)."""
    name = a.dtype.name
    if name == "bfloat16":
        a = a.view(np.uint16)
    return {"array": kind, "dtype": name}, a


def _encode(obj, arrays):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            node, a = {"array": "torch", "dtype": "bfloat16"}, \
                t.view(torch.int16).numpy().view(np.uint16)
        else:
            node, a = _array("torch", t.numpy())
    elif isinstance(obj, jax.Array):
        node, a = _array("jax", np.asarray(obj))
    elif isinstance(obj, (np.ndarray, np.generic)):
        node, a = _array("numpy", np.asarray(obj))
    elif isinstance(obj, (list, tuple)):
        return {"list" if isinstance(obj, list) else "tuple":
                [_encode(v, arrays) for v in obj]}
    elif hasattr(obj, "items"):
        return {"dict": [[k, _encode(v, arrays)] for k, v in obj.items()]}
    elif obj is None or isinstance(obj, (bool, int, float, str)):
        return {"value": obj}
    else:
        raise TypeError(f"cannot save a {type(obj).__name__}")
    node["index"] = len(arrays)
    node["scalar"] = isinstance(obj, np.generic)
    arrays.append(a)
    return node


def _decode(node, saved):
    if "value" in node:
        return node["value"]
    if "dict" in node:
        return {k: _decode(v, saved) for k, v in node["dict"]}
    if "list" in node:
        return [_decode(v, saved) for v in node["list"]]
    if "tuple" in node:
        return tuple(_decode(v, saved) for v in node["tuple"])
    a = saved[f"a{node['index']}"]
    if node["array"] == "torch":
        if node["dtype"] == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    if node["dtype"] == "bfloat16":
        a = a.view(ml_dtypes.bfloat16)
    if node["array"] == "jax":
        return jnp.asarray(a)
    return a[()] if node["scalar"] else a


def test_round_trip_is_bit_for_bit(tmp_path_factory):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 4).astype(np.float32)
    value = {
        "numpy": x, "scalar": np.float32(2.5), "int64": np.arange(5),
        "torch": torch.from_numpy(x), "torch_bf16":
            torch.from_numpy(x).bfloat16(),
        "jax": jnp.asarray(x), "jax_bf16": jnp.asarray(x, jnp.bfloat16),
        35.0: ["a", 1, 2.0, None, True], None: (np.bool_(True),),
        "nested": {"params": {"kernel": x[:1]}},
    }
    got = computed_once(tmp_path_factory, "cache_round_trip",
                        lambda: value)
    assert list(got) == list(value)
    np.testing.assert_array_equal(got["numpy"], x)
    assert got["scalar"] == np.float32(2.5)
    assert isinstance(got["scalar"], np.float32)
    assert got["int64"].dtype == np.int64
    assert torch.equal(got["torch"], value["torch"])
    assert torch.equal(got["torch_bf16"], value["torch_bf16"])
    assert got["torch_bf16"].dtype == torch.bfloat16
    assert isinstance(got["jax"], jax.Array)
    np.testing.assert_array_equal(np.asarray(got["jax"]), x)
    assert got["jax_bf16"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(got["jax_bf16"], np.float32),
        np.asarray(value["jax_bf16"], np.float32))
    assert got[35.0] == ["a", 1, 2.0, None, True]
    assert got[None] == (np.bool_(True),)
    np.testing.assert_array_equal(got["nested"]["params"]["kernel"], x[:1])
    with pytest.raises(TypeError, match="cannot save"):
        computed_once(tmp_path_factory, "cache_refusal", lambda: object())


def test_computed_once_under_concurrent_callers(tmp_path_factory):
    """Eight threads ask at once (each with its own lock file handle, as
    workers do): one computes, every one gets the value."""
    calls, got = [], []

    def compute():
        calls.append(1)
        return {"x": np.arange(3)}

    def ask():
        got.append(computed_once(tmp_path_factory, "cache_once", compute))

    threads = [threading.Thread(target=ask) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and len(got) == 8
    for g in got:
        np.testing.assert_array_equal(g["x"], np.arange(3))
