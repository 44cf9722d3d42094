"""The port's differential privacy and robust reducers (CPU) against the JAX
package's, after ``tests/test_fl_algorithms.py`` (the secure and DP cases)
and ``tests/test_fl_robust.py``.

- ``global_norm`` and ``clip_by_global_norm``: byte identity with the
  jitted reference (each leaf's sum of squares laid out as XLA:CPU's tree
  reduction lays it out, ``ops/xla_cpu.leaf_sum_sq``) over leaves of many
  shapes and dtypes.
- ``privatize``: its noise comes from a ``torch.Generator`` (another stream
  than the reference's key): held to the noise scale, to clip-only bytes at
  multiplier 0, and to determinism per generator seed.
- ``tree_median`` and ``tree_trimmed_mean``: byte identity with the
  reference at even and odd counts, every trim, above and below 32
  contributions; ``krum_scores`` within 1e-6 relative; ``krum`` returns the
  reference's pick verbatim; ``multi_krum`` the reference's average.
- The seed-era fixed-point primitives: sums, leaks, keys, guards.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from rayfed_tpu.fl import dp as jdp
from rayfed_tpu.fl import robust as jr
from rayfed_tpu.fl import secagg as jsa
from rayfed_tpu_torch.fl import dp
from rayfed_tpu_torch.fl import robust as tr
from rayfed_tpu_torch.fl import secagg as sa
from rayfed_tpu_torch.fl.fedavg import tree_average

CPU = torch.device("cpu")
PARTIES = ["alice", "bob", "carol"]
KEY = b"shared-secret-group-key"


def _raw(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair(tree_np):
    return ({k: jnp.asarray(v) for k, v in tree_np.items()}, {k: _to_torch(v) for k, v in tree_np.items()})


LEAF_SHAPES = [
    [(64, 48), (1000,), (3, 5)],
    [(3, 3, 64, 64), (64,), (512, 10), (10,)],
    [(7, 9), (2, 33, 40), (100,), (1,)],
    [(65543,)],
    [(32,), (9, 32), (16, 16), (40, 3), (3, 1000)],
]


def _tree(shapes, seed, scale=1.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {f"l{i}": (rng.standard_normal(s) * rng.uniform(0.01, 3) * scale).astype(dtype)
            for i, s in enumerate(shapes)}


# -- differential privacy ----------------------------------------------------------


@pytest.mark.parametrize("shapes", LEAF_SHAPES, ids=lambda s: "x".join(str(len(t)) for t in s))
def test_global_norm_and_clip_bytes_equal_the_reference(shapes):
    for seed in range(3):
        jt, tt = _pair(_tree(shapes, seed))
        assert _raw(dp.global_norm(tt)) == _raw(jdp.global_norm(jt)), seed
        for clip in (0.5, 1e9):
            (jc, jn), (tc, tn) = jdp.clip_by_global_norm(jt, clip), dp.clip_by_global_norm(tt, clip)
            assert _raw(tn) == _raw(jn)
            for k in jt:
                assert _raw(tc[k]) == _raw(jc[k]), (seed, clip, k)


def test_clip_keeps_the_leaf_dtypes_and_bytes_in_bf16():
    tree = _tree([(64, 48), (7,)], 4, scale=10.0, dtype=ml_dtypes.bfloat16)
    jt, tt = _pair(tree)
    (jc, jn), (tc, tn) = jdp.clip_by_global_norm(jt, 1.0), dp.clip_by_global_norm(tt, 1.0)
    assert _raw(tn) == _raw(jn)
    for k in jt:
        assert tc[k].dtype == torch.bfloat16 and _raw(tc[k]) == _raw(jc[k]), k


def test_clip_by_global_norm():
    tree = {"a": torch.full((4,), 3.0), "b": torch.full((9,), 4.0)}
    clipped, norm = dp.clip_by_global_norm(tree, 5.0)
    assert float(norm) == pytest.approx(np.sqrt(4 * 9 + 9 * 16), rel=1e-6)
    assert float(dp.global_norm(clipped)) == pytest.approx(5.0, rel=1e-5)
    small = {"a": torch.tensor([0.1, 0.2])}
    out, _ = dp.clip_by_global_norm(small, 5.0)
    assert _raw(out["a"]) == _raw(small["a"])


def test_privatize_noise_scale():
    tree = {"w": torch.zeros(20_000)}
    out = dp.privatize(tree, torch.Generator().manual_seed(0), clip_norm=1.0, noise_multiplier=0.5)
    assert float(out["w"].std()) == pytest.approx(0.5, rel=0.05)
    again = dp.privatize(tree, torch.Generator().manual_seed(0), clip_norm=1.0, noise_multiplier=0.5)
    assert _raw(again["w"]) == _raw(out["w"])
    out0 = dp.privatize(tree, torch.Generator().manual_seed(0), clip_norm=1.0, noise_multiplier=0.0)
    assert _raw(out0["w"]) == _raw(tree["w"])
    # Clip-only equals the reference's clip, byte for byte.
    jt, tt = _pair(_tree([(64, 48), (5,)], 9, scale=4.0))
    want = jdp.privatize(jt, jax.random.PRNGKey(0), clip_norm=1.0, noise_multiplier=0.0)
    got = dp.privatize(tt, torch.Generator().manual_seed(0), clip_norm=1.0, noise_multiplier=0.0)
    assert all(_raw(got[k]) == _raw(want[k]) for k in jt)


def test_secure_composition_range_check():
    with pytest.raises(ValueError, match="truncate DP noise"):
        dp.check_secure_composition(clip_norm=4.0, noise_multiplier=1.0, secure_clip=8.0)
    safe = dp.secure_clip_for(clip_norm=4.0, noise_multiplier=1.0)
    assert safe == pytest.approx(4.0 + 6 * 4.0) == jdp.secure_clip_for(clip_norm=4.0, noise_multiplier=1.0)
    dp.check_secure_composition(clip_norm=4.0, noise_multiplier=1.0, secure_clip=safe)
    dp.check_secure_composition(clip_norm=4.0, noise_multiplier=0.0, secure_clip=8.0)
    with pytest.raises(ValueError) as mine:
        dp.check_secure_composition(clip_norm=2.0, noise_multiplier=0.3, secure_clip=2.5)
    with pytest.raises(ValueError) as theirs:
        jdp.check_secure_composition(clip_norm=2.0, noise_multiplier=0.3, secure_clip=2.5)
    assert str(mine.value) == str(theirs.value)


# -- the fixed-point secure sum -------------------------------------------------------


def _updates():
    rng = np.random.default_rng(0)
    return {p: {"w": rng.standard_normal((64, 64)).astype(np.float32),
                "b": rng.standard_normal(5).astype(np.float32)} for p in PARTIES}


def test_secure_sum_matches_plain_average():
    updates = _updates()
    masked = [sa.mask_update({k: torch.from_numpy(v) for k, v in updates[p].items()}, party=p,
                             parties=PARTIES, round_num=3, group_key=KEY) for p in PARTIES]
    total = sa.unmask_sum(masked)
    jtotal = jsa.unmask_sum([jsa.mask_update({k: jnp.asarray(v) for k, v in updates[p].items()}, party=p,
                                             parties=PARTIES, round_num=3, group_key=KEY) for p in PARTIES])
    expected = tree_average([{k: torch.from_numpy(v) for k, v in updates[p].items()} for p in PARTIES])
    for k in ("w", "b"):
        assert _raw(total[k]) == _raw(jtotal[k])
        np.testing.assert_allclose((total[k] / len(PARTIES)).numpy(), expected[k].numpy(), atol=1e-4)


def test_masked_update_is_not_the_raw_update():
    u = _updates()["alice"]
    masked = sa.mask_update({k: torch.from_numpy(v) for k, v in u.items()}, party="alice", parties=PARTIES,
                            round_num=0, group_key=KEY)
    leaked = masked["w"].view(torch.int32).numpy().astype(np.int64).astype(np.float32).ravel()
    assert abs(np.corrcoef(u["w"].ravel(), leaked)[0, 1]) < 0.1


def test_secure_sum_changes_with_round_and_key():
    u = {k: torch.from_numpy(v) for k, v in _updates()["alice"].items()}
    m1 = sa.mask_update(u, party="alice", parties=PARTIES, round_num=0, group_key=KEY)
    m2 = sa.mask_update(u, party="alice", parties=PARTIES, round_num=1, group_key=KEY)
    m3 = sa.mask_update(u, party="alice", parties=PARTIES, round_num=0, group_key=b"other")
    assert _raw(m1["w"]) != _raw(m2["w"]) and _raw(m1["w"]) != _raw(m3["w"])
    assert sa.pairwise_key(KEY, "alice", "bob", 5) == sa.pairwise_key(KEY, "bob", "alice", 5)


def test_secure_ring_overflow_guard():
    masked = [sa.mask_update({"w": torch.ones(2)}, party=p, parties=PARTIES, round_num=0, group_key=KEY,
                             clip=8.0) for p in PARTIES]
    with pytest.raises(ValueError, match="overflow"):
        sa.unmask_sum(masked * 2000, clip=8.0)
    with pytest.raises(ValueError, match="at least one"):
        sa.unmask_sum([])


def test_secure_clipping_applies():
    big = {"w": torch.full((3,), 100.0)}
    masked = [sa.mask_update(big, party=p, parties=PARTIES, round_num=0, group_key=KEY, clip=1.0)
              for p in PARTIES]
    total = sa.unmask_sum(masked, clip=1.0)
    np.testing.assert_allclose(total["w"].numpy(), np.full(3, 3.0), atol=1e-3)


# -- robust reducers --------------------------------------------------------------------


def _contribs(n, seed, shapes=((33, 5), (100,), (3,)), outlier=None):
    rng = np.random.default_rng(seed)
    trees = [{f"l{i}": rng.standard_normal(s).astype(np.float32) for i, s in enumerate(shapes)} for _ in range(n)]
    if outlier is not None:
        trees[outlier] = {k: v * np.float32(100.0) for k, v in trees[outlier].items()}
    return trees, [{k: torch.from_numpy(v) for k, v in t.items()} for t in trees]


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6, 7, 40])
def test_median_and_trimmed_mean_bytes_equal_the_reference(n):
    jt, tt = _contribs(n, n, outlier=0)
    want, got = jr.tree_median(jt), tr.tree_median(tt)
    assert all(_raw(got[k]) == _raw(want[k]) for k in want), "median"
    for trim in range(0, (n - 1) // 2 + 1):
        want, got = jr.tree_trimmed_mean(jt, trim=trim), tr.tree_trimmed_mean(tt, trim=trim)
        assert all(_raw(got[k]) == _raw(want[k]) for k in want), trim


def test_median_of_an_even_count_is_the_midpoint():
    trees = [{"w": torch.tensor([v])} for v in (1.0, 2.0, 4.0, 8.0)]
    assert float(tr.tree_median(trees)["w"]) == 3.0


def _tree_v(v, extra=0.0):
    return {"w": torch.full((3, 2), float(v)), "b": torch.tensor([float(v) + extra])}


def test_tree_median_resists_outlier():
    trees = [_tree_v(0.9), _tree_v(1.0), _tree_v(1.1), _tree_v(1.0), _tree_v(1e6)]
    med = tr.tree_median(trees)
    assert float(med["w"].max()) <= 1.1
    np.testing.assert_allclose(med["b"].numpy(), [1.0], atol=0.2)


def test_tree_trimmed_mean_drops_extremes():
    trees = [_tree_v(v) for v in (1.0, 2.0, 3.0, 4.0, 1e9)]
    out = tr.tree_trimmed_mean(trees, trim=1)
    np.testing.assert_allclose(out["w"].numpy(), np.full((3, 2), 3.0), rtol=1e-6)
    plain = tr.tree_trimmed_mean(trees[:4], trim=0)
    np.testing.assert_allclose(plain["b"].numpy(), [2.5], rtol=1e-6)
    for trim in (3, -1):
        with pytest.raises(ValueError, match="trim"):
            tr.tree_trimmed_mean(trees, trim=trim)


def test_trimmed_mean_preserves_dtype():
    vals = (1.0, 2.0, 3.0)
    jt = [{"w": jnp.ones((4,), jnp.bfloat16) * v, "i": jnp.full((2,), int(v), jnp.int32)} for v in vals]
    tt = [{"w": torch.ones(4, dtype=torch.bfloat16) * v, "i": torch.full((2,), int(v), dtype=torch.int32)}
          for v in vals]
    for fn in (functools.partial(tr.tree_trimmed_mean, trim=1), tr.tree_median):
        out = fn(tt)
        assert out["w"].dtype == torch.bfloat16 and out["i"].dtype == torch.float32
    want = jr.tree_trimmed_mean(jt, trim=1)
    got = tr.tree_trimmed_mean(tt, trim=1)
    assert _raw(got["w"]) == _raw(want["w"]) and _raw(got["i"]) == _raw(want["i"])


@pytest.mark.parametrize("n,f", [(4, 1), (5, 1), (7, 2), (12, 3)])
def test_krum_scores_and_picks_equal_the_reference(n, f):
    """The scores within 1e-6 (the Gram product's summation order is the
    host's library kernel's; everything around it is byte-held in
    ``tests/test_torch_subnormals_models.py``), their order, the pick and
    the multi-Krum average byte for byte."""
    jt, tt = _contribs(n, 50 + n, outlier=n - 1)
    want = np.asarray(jr.krum_scores(jt, num_byzantine=f))
    got = tr.krum_scores(tt, num_byzantine=f).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.argsort(got, kind="stable").tolist() == np.argsort(want, kind="stable").tolist()
    pick, jpick = tr.krum(tt, num_byzantine=f), jr.krum(jt, num_byzantine=f)
    assert all(_raw(pick[k]) == _raw(jpick[k]) for k in jpick)
    m = n - f - 2
    got_mk, want_mk = tr.multi_krum(tt, num_byzantine=f, num_selected=m), \
        jr.multi_krum(jt, num_byzantine=f, num_selected=m)
    for k in want_mk:
        assert _raw(got_mk[k]) == _raw(want_mk[k]), k


def test_krum_selects_central_contribution():
    honest = [_tree_v(v) for v in (0.9, 1.0, 1.1, 1.05)]
    trees = honest + [_tree_v(50.0)]
    scores = tr.krum_scores(trees, num_byzantine=1)
    assert scores.shape == (5,) and int(torch.argmax(scores)) == 4
    picked = tr.krum(trees, num_byzantine=1)
    assert any(picked is h for h in honest)
    mk = tr.multi_krum(trees, num_byzantine=1, num_selected=2)
    assert float(mk["w"].max()) < 2.0
    with pytest.raises(ValueError, match="f \\+ 3"):
        tr.krum(trees[:3], num_byzantine=1)
    with pytest.raises(ValueError, match="num_selected"):
        tr.multi_krum(trees, num_byzantine=1, num_selected=0)
    with pytest.raises(ValueError, match="n - f - 2"):
        tr.multi_krum(trees, num_byzantine=1, num_selected=3)
    with pytest.raises(ValueError, match="num_byzantine"):
        tr.krum_scores(trees, num_byzantine=-1)
    assert float(tr.tree_trimmed_mean((t for t in trees), trim=1)["w"].max()) < 2.0


def test_krum_gram_product_ignores_the_tf32_switch(monkeypatch):
    """The Gram product is an elementwise f32 product summed in f32, never
    a matmul the global TF32 switch could route to the tensor cores."""
    monkeypatch.setattr(torch, "mm", None)
    monkeypatch.setattr(torch, "matmul", None)
    _, tt = _contribs(5, 3)
    assert tr.krum_scores(tt, num_byzantine=1).shape == (5,)


def test_robust_reducers_as_the_round_loops_aggregator():
    """``run_fedavg_rounds(aggregator=...)`` in one party, and
    ``aggregate(reducer=...)``: the reducer's output is the round's result."""
    import rayfed_tpu_torch as fed
    from tests.multiproc import make_cluster

    @fed.remote
    class Trainer:
        def train(self, params):
            return {"w": params["w"] + 1.0}

    @fed.remote
    def make(v):
        return {"w": torch.full((4,), float(v))}

    fed.init(address="local", cluster=make_cluster(["solo"]), party="solo", device=CPU)
    try:
        out = fed.fl.run_fedavg_rounds({"solo": Trainer.party("solo").remote()}, {"w": torch.zeros(4)}, rounds=3,
                                       aggregator=tr.tree_median)
        assert out["w"].tolist() == [3.0] * 4
        med = fed.fl.aggregate([make.party("solo").remote(2.0)], reducer=tr.tree_median)
        assert med["w"].tolist() == [2.0] * 4
    finally:
        fed.shutdown()
