"""The port's int8 gradient compression (``repro_torch.optim.compression``)
against the JAX package's (``repro.optim.compression``).

Every compression case of ``tests/test_optim.py`` runs on both packages
(the bounded-error property over fixed seeds and scales, since
``hypothesis`` may be missing); ``q`` and ``scale`` are the same bits as
JAX's on seeded fp32 and bf16 inputs, on values that fall exactly on half
a quantum (round half to even) and on a zero tensor. ``allreduce_compressed``
runs on 4 gloo ranks (one spawn of a (2, 2) mesh): over the data axis
(groups {0, 2} and {1, 3}) and over the whole world, each rank's reduced
tree and new residuals against JAX's own function under ``jax.vmap(...,
axis_name=...)`` over the stacked rank gradients, bitwise or within fp32
1e-6 relative. The JAX references are computed after the spawn.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.optim import compression as JC
from repro_torch.launch import selftest as ST
from repro_torch.models.common import tree_leaves
from repro_torch.optim import compression as C

torch.set_num_threads(1)

SPAWN_TIMEOUT = 120.0
REL = 1e-6
# (2, 2) mesh, rank = data * 2 + model: each data-axis group's members
GROUPS = {"data": [[0, 2], [1, 3]], "world": [[0, 1, 2, 3]]}
SHAPES = {"a": (6, 5), "b/c": (7,), "b/d": (3, 4), "z": (2, 3)}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(t):
    return t.detach().numpy()


# ---------------------------------------------------------------------------
# tests/test_optim.py's cases on both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,scale", [(0, 1e-4), (1, 1.0), (7, 3.7),
                                        (42, 250.0), (100, 1e3)])
def test_quantize_bounded_error(seed, scale):
    x = np.random.default_rng(seed).standard_normal(64).astype(
        np.float32) * scale
    jq, js = JC.quantize_int8(jnp.asarray(x))
    q, s = C.quantize_int8(_t(x))
    for deq, sc in ((np.asarray(JC.dequantize_int8(jq, js)), float(js)),
                    (_np(C.dequantize_int8(q, s)), float(s))):
        assert np.abs(deq - x).max() <= sc * 0.5 + 1e-6


def test_error_feedback_accumulates_to_truth():
    """sum of the dequantized grads + the final residual == the sum of the
    true grads, on both packages, with the same residual bits per step."""
    rng = np.random.default_rng(0)
    jres, res = jnp.zeros((32,), jnp.float32), torch.zeros(32)
    sent = {"jax": np.zeros(32, np.float32), "port": np.zeros(32, np.float32)}
    true = np.zeros(32, np.float32)
    for _ in range(20):
        g = rng.standard_normal(32).astype(np.float32)
        jq, js, jres = JC.compress_with_feedback(jnp.asarray(g), jres)
        q, s, res = C.compress_with_feedback(_t(g), res)
        assert np.array_equal(_np(q), np.asarray(jq))
        assert np.array_equal(_np(res), np.asarray(jres))
        sent["jax"] += np.asarray(JC.dequantize_int8(jq, js))
        sent["port"] += _np(C.dequantize_int8(q, s))
        true += g
    for k, r in (("jax", np.asarray(jres)), ("port", _np(res))):
        np.testing.assert_allclose(sent[k] + r, true, rtol=1e-4, atol=1e-4)


def test_compress_pytree_roundtrip_structure():
    jg = {"a": jnp.ones((4,)), "b": {"c": jnp.full((2, 2), -3.0)}}
    g = {"a": torch.ones(4), "b": {"c": torch.full((2, 2), -3.0)}}
    jpacked, jr = JC.compress_pytree(jg, JC.init_residuals(jg))
    packed, r = C.compress_pytree(g, C.init_residuals(g))
    for out in (JC.decompress_pytree(jpacked), C.decompress_pytree(packed)):
        np.testing.assert_allclose(np.asarray(out["a"]), np.ones(4),
                                   rtol=1e-2)
        np.testing.assert_allclose(np.asarray(out["b"]["c"]),
                                   np.full((2, 2), -3.0), rtol=1e-2)
    assert [p for p, _ in tree_leaves(r)] == [p for p, _ in tree_leaves(g)]
    assert jax.tree_util.tree_structure(jr) == jax.tree_util.tree_structure(
        jg)
    for (p, x), y in zip(tree_leaves(r), jax.tree_util.tree_leaves(jr)):
        assert x.dtype == torch.float32 and np.array_equal(_np(x),
                                                           np.asarray(y)), p


# ---------------------------------------------------------------------------
# q and scale: the same bits as JAX
# ---------------------------------------------------------------------------

_HALF = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5,
                  3.5, 64.5, -0.0], np.float32)


def _inputs():
    rng = np.random.default_rng(3)
    return {
        "normal": rng.standard_normal((33, 17)).astype(np.float32),
        "wide": (rng.standard_normal(4096) * 1e3).astype(np.float32),
        "tiny": (rng.standard_normal(100) * 1e-30).astype(np.float32),
        "half_quanta": _HALF,          # amax 127: scale 1, x / scale exact
        "half_quanta_x3": _HALF * np.float32(3.0),
        "zeros": np.zeros((5, 3), np.float32),
    }


@pytest.mark.parametrize("name", list(_inputs()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q_and_scale_bits_match_jax(name, dtype):
    x = _inputs()[name]
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype))
    jq, js = JC.quantize_int8(jx)
    q, s = C.quantize_int8(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(_np(q), np.asarray(jq))
    assert _np(s).tobytes() == np.asarray(js).tobytes()
    assert np.array_equal(_np(C.dequantize_int8(q, s)),
                          np.asarray(JC.dequantize_int8(jq, js)))


def test_half_quanta_round_to_even():
    q, s = C.quantize_int8(_t(_HALF))
    assert float(s) == 1.0
    assert _np(q).tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126, 4, 64, 0]


# ---------------------------------------------------------------------------
# allreduce_compressed on 4 gloo ranks against JAX under vmap
# ---------------------------------------------------------------------------


def _rank_trees():
    """Per rank: (gradient tree, residual tree) as flat numpy dicts. Rank
    scales differ by up to 50x, so the common scale re-quantizes."""
    rng = np.random.default_rng(11)
    out = []
    for r in range(4):
        g = {k: (rng.standard_normal(sh) * (1 + 12 * r)).astype(np.float32)
             for k, sh in SHAPES.items()}
        g["z"][:] = 0.0 if r == 1 else g["z"]
        res = {k: (rng.standard_normal(sh) * 1e-2).astype(np.float32)
               for k, sh in SHAPES.items()}
        out.append((g, res))
    return out


def _nest(flat):
    out = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _jax_group(trees, members):
    """JAX's allreduce_compressed under vmap over the members' stacked
    trees: per member (flat out, flat residuals)."""
    g = _nest({k: jnp.stack([trees[m][0][k] for m in members])
               for k in SHAPES})
    r = _nest({k: jnp.stack([trees[m][1][k] for m in members])
               for k in SHAPES})
    out, res = jax.vmap(lambda a, b: JC.allreduce_compressed(a, b, "x"),
                        axis_name="x")(g, r)
    flat = {}
    for name, tree in (("out", out), ("resid", res)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            key = "/".join(p.key for p in path)
            flat[f"{name}/{key}"] = np.asarray(leaf)
    return [{k: v[i] for k, v in flat.items()} for i in range(len(members))]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One spawn of 4 gloo ranks on a (2, 2) mesh, then JAX's references:
    (the ranks' results, {group: {rank: flat reference}})."""
    d = tmp_path_factory.mktemp("compress")
    trees = _rank_trees()
    arrays = {}
    for r, (g, res) in enumerate(trees):
        arrays.update({f"g{r}/{k}": v for k, v in g.items()})
        arrays.update({f"r{r}/{k}": v for k, v in res.items()})
    np.savez(d / "grads.npz", **arrays)
    job = dict(name="compress", kind="compress", data="grads",
               groups={"data": ["data"], "world": ["data", "model"]})
    ST.spawn(4, ST.mesh_cells, ((2, 2), [job], str(d), str(d)),
             device="cpu", timeout=SPAWN_TIMEOUT)
    got = np.load(d / "compress.npz")
    refs = {}
    for name, groups in GROUPS.items():
        refs[name] = {}
        for members in groups:
            for m, ref in zip(members, _jax_group(trees, members)):
                refs[name][m] = ref
    return got, refs


@pytest.mark.parametrize("group", list(GROUPS))
@pytest.mark.parametrize("rank", range(4))
def test_allreduce_compressed_matches_jax_vmap(run, group, rank):
    got, refs = run
    want = refs[group][rank]
    assert {k.split("/", 2)[2] for k in got.files
            if k.startswith(f"{group}/{rank}/")} == set(want)
    for k, w in want.items():
        g = got[f"{group}/{rank}/{k}"]
        assert g.dtype == np.float32 and g.shape == w.shape, k
        if not np.array_equal(g, w):
            err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= REL, (k, err)


def test_group_members_agree_and_carry_their_own_residuals(run):
    """Every member of a group holds the same reduced tree; residuals stay
    each rank's own (the world's equal the data axis's: both quantize the
    same local sums)."""
    got, _ = run
    for name, groups in GROUPS.items():
        for members in groups:
            for k in SHAPES:
                outs = [got[f"{name}/{m}/out/{k}"] for m in members]
                assert all(np.array_equal(outs[0], o) for o in outs[1:])
    for r in range(4):
        for k in SHAPES:
            assert np.array_equal(got[f"data/{r}/resid/{k}"],
                                  got[f"world/{r}/resid/{k}"])


def test_allreduce_at_one_rank_is_the_local_round_trip():
    """A group of one gives the bits of decompress(compress(g, r)) and the
    same residuals (what the card checks at world 1 over NCCL)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.parallel.mesh import make_mesh
    g, res = _rank_trees()[2]
    g = _nest({k: _t(v) for k, v in g.items()})
    res = _nest({k: _t(v) for k, v in res.items()})
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh((1, 1), ("data", "model"))
            out, new = C.allreduce_compressed(g, res, mesh.group(("data",)))
        finally:
            dist.destroy_process_group()
    packed, want_r = C.compress_pytree(g, res)
    want = C.decompress_pytree(packed)
    for (p, a), (_, b) in zip(tree_leaves(out), tree_leaves(want)):
        assert torch.equal(a, b), p
    for (p, a), (_, b) in zip(tree_leaves(new), tree_leaves(want_r)):
        assert torch.equal(a, b), p
