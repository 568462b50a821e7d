"""The grouped quant wrappers (one launch over many leaves) against the
one-leaf wrappers and the JAX package's ``quantize_array``.

On CPU tensors ``quantize_leaves``/``dequantize_leaves`` run their plain
versions, which go through the same leaf table and packed arenas as the
kernels (``_quantize_table``, ``_dequantize_table``), so these tests hold
the table's layout as well as the arithmetic.  Everything is bitwise:
int8 payloads, the bits of every scale (NaN included) and of every
dequantized value.  The reference's Pallas kernels run in interpret mode.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ckpt as RC
from repro.kernels import ops as RO

import repro_torch.ckpt as TC
from repro_torch import interop
from repro_torch.ckpt import store as TS
from repro_torch.ckpt.tree import tree_leaves
from repro_torch.kernels import ops as PO
from repro_torch.kernels import quant_blockwise as PQ


def _leaf_cases():
    """(name, f32 array) leaves from numpy seed 17: lognormal magnitudes
    with random signs at ragged and edge sizes (some multi-dimensional),
    an all-zero leaf, and one with a NaN, +-inf and subnormals in separate
    groups."""
    rng = np.random.default_rng(17)

    def lognormal(n):
        sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
        return (rng.lognormal(0.0, 1.0, n) * sign).astype(np.float32)
    cases = [("lognormal_4096", lognormal(4096).reshape(64, 64)),
             ("lognormal_4097", lognormal(4097)),
             ("lognormal_511", lognormal(511)),
             ("lognormal_512", lognormal(512)),
             ("lognormal_130", lognormal(130)),
             ("lognormal_36864", lognormal(36864).reshape(6, 48, 128)),
             ("lognormal_1000003", lognormal(1000003))]
    special = lognormal(1500)
    special[3] = np.nan                          # group 0
    special[200] = np.inf                        # group 1
    special[300] = -np.inf                       # group 2
    special[512:640] = (rng.standard_normal(128) * 1e-40).astype(np.float32)
    special[700] = 1e-41                         # beside normals
    return cases + [("zeros_2048", np.zeros((2, 1024), np.float32)),
                    ("special_1500", special)]


CASES = _leaf_cases()
IDS = [name for name, _ in CASES]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.fixture(scope="module")
def grouped():
    """All leaves through ``ops.quantize_arrays`` and back through
    ``ops.dequantize_arrays``, each in one call, and through
    ``quantize_leaves_plain``."""
    xs = [torch.from_numpy(x) for _, x in CASES]
    q, s, views = PO.quantize_arrays(xs)
    outs = PO.dequantize_arrays(
        [v[0] for v in views], [v[1] for v in views],
        shapes=[x.shape for x in xs], dtypes=["float32"] * len(xs),
        pads=[v[2] for v in views])
    return q, s, views, outs, PQ.quantize_leaves_plain(xs)[2]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_grouped_quantize_leaf_by_leaf(grouped, i):
    """Leaf i of one grouped call equals ``quantize_array`` on it alone,
    the plain grouped version's, and the reference's."""
    _, x = CASES[i]
    views, plain = grouped[2], grouped[4]
    q, s, pad = views[i]
    one = PO.quantize_array(torch.from_numpy(x))
    rq, rs, rpad = RO.quantize_array(jnp.asarray(x), force_interpret=True)
    assert pad == one[2] == plain[i][2] == rpad
    for got in (one[0], plain[i][0], np.asarray(rq)):
        _same(q.numpy(), np.asarray(got))
    for got in (one[1], plain[i][1], np.asarray(rs)):
        _same(s.numpy(), np.asarray(got))


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_grouped_dequantize_leaf_by_leaf(grouped, i):
    """Leaf i of one grouped dequantize call equals ``dequantize_array``
    and the reference's on its payload, in the leaf's own shape."""
    _, x = CASES[i]
    views, outs = grouped[2], grouped[3]
    q, s, pad = views[i]
    one = PO.dequantize_array(q, s, shape=x.shape, dtype="float32", pad=pad)
    want = RO.dequantize_array(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                               shape=x.shape, dtype="float32", pad=pad,
                               force_interpret=True)
    _same(outs[i].numpy(), one.numpy())
    _same(outs[i].numpy(), np.asarray(want))


def test_table_covers_every_group_once():
    """The leaf table partitions the launch's groups: each leaf owns
    (n + pad) / 128 consecutive groups from its ``first``, its payload
    starts 128 bytes a group into the q arena (16-byte aligned) and its
    scales 4 bytes a group into the scales arena."""
    xs = [torch.from_numpy(x).reshape(-1) for _, x in CASES]
    q, s, rows, views = PQ._quantize_table(xs, "cpu")
    col = {c: k for k, c in enumerate(PQ.TABLE_COLUMNS)}
    covered = np.zeros(s.numel(), np.int64)
    for x, row, (lq, ls, pad) in zip(xs, rows, views):
        n, D, first = row[col["n"]], row[col["d"]], row[col["first"]]
        assert (n, row[col["f32"]]) == (x.numel(), x.data_ptr())
        assert (pad, D) == PQ.pad_of(n)
        groups = (n + pad) // 128
        covered[first:first + groups] += 1
        q_off = row[col["q"]] - q.data_ptr()
        assert q_off == 128 * first and q_off % 16 == 0
        assert row[col["s"]] - s.data_ptr() == 4 * first
        assert lq.storage_offset() == q_off and ls.storage_offset() == first
        assert lq.shape == ((n + pad) // D, D) and ls.shape == (lq.shape[0],
                                                                D // 128)
    assert (covered == 1).all()
    _, _, outs, drows, n_groups = PQ._dequantize_table(
        [v[0] for v in views], [v[1] for v in views],
        [x.shape for x in xs], [v[2] for v in views])
    assert n_groups == s.numel()
    assert [r[col["first"]] for r in drows] == [r[col["first"]]
                                               for r in rows]
    assert [r[col["f32"]] for r in drows] == [o.data_ptr() for o in outs]


def test_permuted_leaves_give_the_same_payload(grouped):
    views = grouped[2]
    order = np.random.default_rng(5).permutation(len(CASES))
    _, _, pviews = PQ.quantize_leaves(
        [torch.from_numpy(CASES[i][1]) for i in order])
    for (pq, ps, ppad), i in zip(pviews, order):
        q, s, pad = views[i]
        assert ppad == pad
        _same(pq.numpy(), q.numpy())
        _same(ps.numpy(), s.numpy())


def test_cpu_leaves_take_the_plain_versions():
    xs = [torch.from_numpy(x) for _, x in CASES[:3]]
    launches = (PQ.quantize_leaves.launches, PQ.dequantize_leaves.launches)
    calls = (PQ.quantize_plain.calls, PQ.dequantize_plain.calls)
    _, _, views = PQ.quantize_leaves(xs)
    PQ.dequantize_leaves([v[0] for v in views], [v[1] for v in views],
                         [x.shape for x in xs], [v[2] for v in views])
    assert (PQ.quantize_leaves.launches,
            PQ.dequantize_leaves.launches) == launches
    assert (PQ.quantize_plain.calls, PQ.dequantize_plain.calls) == (
        calls[0] + 3, calls[1] + 3)


def test_no_leaves():
    q, s, views = PQ.quantize_leaves([])
    assert q.numel() == s.numel() == 0 and views == []
    assert PQ.dequantize_leaves([], [], [], []) == []


def test_validation():
    x = torch.zeros(600)
    with pytest.raises(TypeError, match="float32"):
        PQ.quantize_leaves([x, x.double()])
    with pytest.raises(ValueError, match="one device"):
        PQ.quantize_leaves([x, torch.zeros(600, device="meta")])
    _, _, [(q, s, pad)] = PQ.quantize_leaves([x])
    assert pad == 424
    with pytest.raises(ValueError, match="one entry a leaf"):
        PQ.dequantize_leaves([q], [s], [(600,)], [])
    with pytest.raises(ValueError, match="does not hold"):
        PQ.dequantize_leaves([q], [s], [(601,)], [pad])
    with pytest.raises(ValueError, match="scales"):
        PQ.dequantize_leaves([q], [s[:, :1].contiguous()], [(600,)], [pad])


# ---------------------------------------------------------------------------
# The compressed store hands its leaves over at once
# ---------------------------------------------------------------------------

def _ragged_tree():
    rng = np.random.default_rng(23)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return {"a": f(4097), "b": f(5, 1000), "c": f(36865),
            "d": {"e": f(3, 43691), "small": f(300)},
            "ids": np.arange(5000, dtype=np.int32), "step": np.int32(3),
            "z": np.zeros((64, 64), np.float32)}


def test_store_with_ragged_leaves_writes_the_reference_payload(
        tmp_path, monkeypatch):
    """A CPU store quantizes all compressible leaves in one
    ``quantize_arrays`` call and dequantizes them in one
    ``dequantize_arrays`` call; its npz payload and manifest are the
    reference store's, byte for byte, and both restore alike."""
    npt = _ragged_tree()
    calls = {"quantize_arrays": 0, "dequantize_arrays": 0}
    for name in calls:
        fn = getattr(TS.kops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(TS.kops, name, counted)
    tstore = TC.ShardedStore(TC.StoreConfig(str(tmp_path / "torch"),
                                            compress=True, device="cpu"))
    tree = interop.state_from_numpy(npt, "cpu")
    tstore.save(7, tree)
    rstore = RC.ShardedStore(RC.StoreConfig(str(tmp_path / "jax"),
                                            compress=True))
    rstore.save(7, jax.tree.map(jnp.asarray, npt))
    payloads, mans = {}, {}
    for pkg in ("torch", "jax"):
        gen = tmp_path / pkg / "step_000000007"
        mans[pkg] = json.loads((gen / "manifest.json").read_text())["leaves"]
        with np.load(gen / "shard_00000.npz") as data:
            payloads[pkg] = {k: data[k] for k in data.files}
    assert mans["torch"] == mans["jax"]
    assert sum(e["compressed"] for e in mans["torch"]) == 5
    assert list(payloads["torch"]) == list(payloads["jax"])
    for k, a in payloads["jax"].items():
        _same(payloads["torch"][k], a)

    out, step = tstore.restore(tree)
    rout, rstep = rstore.restore(jax.tree.map(jnp.asarray, npt))
    assert step == rstep == 7
    assert calls == {"quantize_arrays": 1, "dequantize_arrays": 1}
    for a, b in zip(tree_leaves(out), jax.tree.leaves(rout)):
        _same(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("sizes,budget,want", [
    ([4097, 5000, 36865, 131073, 4096], float("inf"), [[0, 1, 2, 3, 4]]),
    ([4097, 5000, 36865, 131073, 4096], 50_000, [[0, 1], [2], [3], [4]]),
    ([4097, 5000, 36865, 131073, 4096], 1, [[0], [1], [2], [3], [4]]),
    ([10, 10, 10], 10 * TS._DEVICE_BYTES_PER_ELEMENT * 2, [[0, 1], [2]]),
    ([], 1, []),
])
def test_batches_cut_within_the_budget(sizes, budget, want):
    """Consecutive runs that each fit the budget; a leaf over it alone."""
    runs = TS._batches(sizes, budget)
    assert runs == want
    for run in runs:
        held = sum(sizes[i] for i in run) * TS._DEVICE_BYTES_PER_ELEMENT
        assert len(run) == 1 or held <= budget


@pytest.mark.parametrize("budget,launches", [(50_000, 4), (1, 5)])
def test_store_batches_leaves_over_a_device_budget(tmp_path, monkeypatch,
                                                   budget, launches):
    """With less device room than the leaves need, a save and a restore
    make one quantize and one dequantize call a batch, and write and
    restore the same payload as a store that made one call each way."""
    npt = _ragged_tree()
    tree = interop.state_from_numpy(npt, "cpu")
    whole = TC.ShardedStore(TC.StoreConfig(str(tmp_path / "whole"),
                                           compress=True, device="cpu"))
    whole.save(7, tree)
    calls = {"quantize_arrays": 0, "dequantize_arrays": 0}
    for name in calls:
        fn = getattr(TS.kops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(TS.kops, name, counted)
    monkeypatch.setattr(TS, "_device_budget", lambda device: budget)
    cut = TC.ShardedStore(TC.StoreConfig(str(tmp_path / "cut"),
                                         compress=True, device="cpu"))
    cut.save(7, tree)
    out, step = cut.restore(tree)
    assert step == 7
    assert calls == {"quantize_arrays": launches,
                     "dequantize_arrays": launches}
    gens = [tmp_path / d / "step_000000007" for d in ("cut", "whole")]
    mans = [json.loads((g / "manifest.json").read_text()) for g in gens]
    assert mans[0]["leaves"] == mans[1]["leaves"]
    assert mans[0]["shards"] == mans[1]["shards"]   # sizes and CRCs
    assert ((gens[0] / "shard_00000.npz").read_bytes()
            == (gens[1] / "shard_00000.npz").read_bytes())
    for a, b in zip(tree_leaves(out), tree_leaves(whole.restore(tree)[0])):
        _same(a.numpy(), b.numpy())
