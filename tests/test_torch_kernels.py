"""The port's three kernels against the reference's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; it is held
against the Pallas kernel (``interpret=True``, as the reference's own
tests run it) and the kernel's ``ref.py`` in float32 (the kernels' bf16
paths are held against the plain versions on the card). Integers
compare exactly; floats within the kernel harness's float32 bound
(``tests/kernel_harness.py``: 3e-5).

The hand-written kernels against these plain versions on the card are
in ``tests/test_torch_gpu.py`` (marked ``gpu``; they skip without a CUDA
device).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention_pallas
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref
from repro.kernels.grouped_moe.ops import grouped_moe_pallas
from repro.kernels.grouped_moe.ref import grouped_moe_ref as jax_grouped_ref
from repro.kernels.router_topk.ops import router_topk_fused_pallas
from repro.kernels.router_topk.ref import router_topk_ref as jax_router_ref
from repro.traces import zipf_routing
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.grouped_moe.ops import grouped_moe_ffn
from repro_torch.kernels.router_topk.ops import router_topk_fused

from test_torch_gpu import (DECODE_CASES, DECODE_PATH_CASES, GROUPED_CASES,
                            ROUTER_CASES, decode_inputs, grouped_inputs,
                            routed_counts, router_inputs)
from test_torch_harness import np_, t_

TOL = dict(rtol=3e-5, atol=3e-5)


# ------------------------------------------------------------------ router

@pytest.mark.parametrize("N,D,E,k,ve,case,block_n", ROUTER_CASES)
def test_router_plain_matches_pallas(N, D, E, k, ve, case, block_n):
    jdt, tdt = jnp.float32, torch.float32
    x, w = router_inputs(N, D, E, case=case)
    want = router_topk_fused_pallas(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                    k=k, valid_experts=ve, block_n=block_n,
                                    interpret=True)
    got = router_topk_fused(t_(x, tdt), t_(w, tdt), k=k, valid_experts=ve)
    names = ("vals", "idx", "pos", "counts", "probs_sum", "z_sq")
    for name, g, wv in zip(names, got, want):
        if name in ("idx", "pos", "counts"):
            assert g.dtype == torch.int32, name
            np.testing.assert_array_equal(np_(g), np.asarray(wv),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(np_(g), np.asarray(wv, np.float32),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
    # and against the reference's plain router (weights + indices)
    rv, ri = jax_router_ref(jnp.asarray(x, jdt), jnp.asarray(w, jdt), k, ve)
    np.testing.assert_array_equal(np_(got[1]), np.asarray(ri))
    np.testing.assert_allclose(np_(got[0]), np.asarray(rv), rtol=1e-5,
                               atol=1e-5)
    if case == "tie":
        assert (np_(got[1])[:, 0] == 1).all()
        assert (np_(got[1])[:, 1] == 2).all()
    if case == "all-to-one":
        assert np_(got[3])[E - 1] == N


# ----------------------------------------------------------------- grouped

def zipf_counts(n_tokens, E, k, alpha=1.2, seed=0):
    idx = zipf_routing(n_tokens, E, k, alpha=alpha, seed=seed)
    return tuple(np.bincount(idx.ravel(), minlength=E))


# the card's "skewed" counts become a Zipf draw of the reference's traces;
# then the layouts the card's tests also hold B2 at, at narrow widths: an
# expert with many tiles (128 tokens top-1 over 4), all pairs in the last
# expert (the tail tile's label then live), qwen2-moe's E = 60 and k = 4,
# and rows that are not whole 16-byte chunks
CPU_GROUPED_CASES = [(c, label, 32, 48) for c, label in GROUPED_CASES
                     if label != "skewed"] + [
    (zipf_counts(40, 8, 2), "zipf", 32, 48),
    (routed_counts(128, 4, 1), "N128-top1", 32, 48),
    ((0, 0, 0, 64), "all-to-one-tail-live", 32, 48),
    (routed_counts(16, 60, 4), "E60-N16-top4", 32, 48),
    ((5, 0, 13, 2), "odd-widths", 36, 70)]


@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
@pytest.mark.parametrize("counts,label,D,F", CPU_GROUPED_CASES,
                         ids=[c[1] for c in CPU_GROUPED_CASES])
def test_grouped_plain_matches_pallas(counts, label, D, F, activation):
    jdt, tdt = jnp.float32, torch.float32
    x, te, wg, wu, wd = grouped_inputs(counts, D, F)
    wu_j = jnp.asarray(wu, jdt) if activation == "swiglu" else None
    args_j = (jnp.asarray(x, jdt), jnp.asarray(te), jnp.asarray(wg, jdt),
              wu_j, jnp.asarray(wd, jdt))
    want = grouped_moe_pallas(*args_j, activation=activation,
                              interpret=True)
    want_ref = jax_grouped_ref(*args_j, activation=activation)
    wu_t = t_(wu, tdt) if activation == "swiglu" else None
    got = grouped_moe_ffn(t_(x, tdt), t_(te), t_(wg, tdt), wu_t,
                          t_(wd, tdt), activation=activation)
    assert got.dtype == tdt and got.shape == x.shape
    for w in (want, want_ref):
        np.testing.assert_allclose(np_(got), np.asarray(w, np.float32),
                                   **TOL)
    assert not np_(got)[-8:].any()                # zero tile -> zeros
    # and so do the padding rows of each group
    assert not np_(got)[~x.any(-1)].any()


# ----------------------------------------------------------- flash-decode

@pytest.mark.parametrize("B,N,G,D,T,kv_len,valid",
                         DECODE_CASES + [c[:-1] for c in DECODE_PATH_CASES])
def test_decode_plain_matches_pallas(B, N, G, D, T, kv_len, valid):
    jdt, tdt = jnp.float32, torch.float32
    q, k, v = decode_inputs(B, N, G, D, T)
    vl = np.asarray(valid, np.int32)
    ks, vs = k[:, :kv_len], v[:, :kv_len]
    want = decode_attention_pallas(jnp.asarray(q, jdt), jnp.asarray(ks, jdt),
                                   jnp.asarray(vs, jdt), jnp.asarray(vl),
                                   interpret=True)
    want_ref = jax_decode_ref(jnp.asarray(q, jdt), jnp.asarray(ks, jdt),
                              jnp.asarray(vs, jdt), jnp.asarray(vl))
    kt, vt = t_(k, tdt), t_(v, tdt)
    # the strided ragged slice of the full cache, as the decode step takes it
    got = decode_attention(t_(q, tdt), kt[:, :kv_len], vt[:, :kv_len],
                           t_(vl))
    assert got.dtype == tdt
    for w in (want, want_ref):
        np.testing.assert_allclose(np_(got), np.asarray(w, np.float32),
                                   **TOL)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Checks that run before any launch: mixed devices and bad shapes
    raise rather than fall back."""
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        grouped_moe_ffn(torch.zeros(12, 8), torch.zeros(2, dtype=torch.int32),
                        torch.zeros(2, 8, 4), None, torch.zeros(2, 4, 8),
                        activation="swiglu")
    with pytest.raises(ValueError):
        decode_attention(x.reshape(1, 1, 4, 8), torch.zeros(1, 3, 1, 8),
                         torch.zeros(1, 3, 1, 8),
                         torch.zeros(1, dtype=torch.int32).to("meta"))


# ------------------------------------------------- the kernels' launch plans

PLAN_SMS = 132   # the H100's SMs


# B2's plan at the timed shapes (gpt2-moe: D 768, F 3072, E 4, top-1,
# GELU; qwen2-moe: D 2048, F 1408, E 60, top-4, SwiGLU) with the path each
# takes: mean rows per expert R / min(E, R / 8) of 8, 12 and 15.6 stream
# the weights (short), 40 and 136 go to the tensor cores (long)
GROUPED_PLAN_PATHS = [
    # tokens, k, E, D, F, swiglu, dtype, path
    (4, 1, 4, 768, 3072, False, torch.float32, "short"),
    (4, 1, 4, 768, 3072, False, torch.bfloat16, "short"),
    (16, 1, 4, 768, 3072, False, torch.float32, "short"),
    (128, 1, 4, 768, 3072, False, torch.float32, "long"),
    (512, 1, 4, 768, 3072, False, torch.float32, "long"),
    (512, 1, 4, 768, 3072, False, torch.bfloat16, "long"),
    (4, 4, 60, 2048, 1408, True, torch.float32, "short"),
    (128, 4, 60, 2048, 1408, True, torch.float32, "short"),
]


def _grouped_rows(tokens, k, E):
    from repro_torch.models.moe import grouped_rows_for
    return grouped_rows_for(tokens * k, E)


@pytest.mark.parametrize("tokens,k,E,D,F,swiglu,dtype,path",
                         GROUPED_PLAN_PATHS)
def test_grouped_plan_picks_the_path(tokens, k, E, D, F, swiglu, dtype,
                                     path):
    from repro_torch.kernels.grouped_moe.ops import LONG_ROWS, grouped_plan
    R = _grouped_rows(tokens, k, E)
    plan = grouped_plan(R, D, F, E, dtype, swiglu, PLAN_SMS)
    assert plan.path == path
    assert (R / min(E, R // 8) >= LONG_ROWS) == (path == "long")


GROUPED_PLAN_SHAPES = [(t, k, E, D, F, sw, dt)
                       for t, k, E, D, F, sw, dt, _ in GROUPED_PLAN_PATHS] + [
    (1, 1, 4, 768, 3072, False, torch.float32),       # one token
    (1024, 1, 4, 768, 3072, True, torch.float32),     # long, SwiGLU
    (2048, 4, 60, 2048, 1408, True, torch.bfloat16),  # long, many experts
    (20, 1, 4, 36, 70, True, torch.float32),          # odd widths: short
    (300, 1, 2, 36, 70, False, torch.bfloat16),       # odd widths, many rows
    (64, 2, 8, 96, 160, True, torch.float32),
    (16, 4, 60, 704, 1000, False, torch.bfloat16),
    (200, 1, 1, 4096, 8192, False, torch.bfloat16),   # the widest K
]


@pytest.mark.parametrize("tokens,k,E,D,F,swiglu,dtype", GROUPED_PLAN_SHAPES)
def test_grouped_plan_fits_the_card(tokens, k, E, D, F, swiglu, dtype):
    """Every product: one cluster of at most 8 blocks holds a column
    block's K splits (the cluster size is the split count), the slices
    are whole ring stages and cover K with no empty split, the columns
    and rows are covered, shared memory within the 227 KB a block may
    use; the short path stages at most MAX_SLICE rows; the long path's
    tiles and shared memory are those of ffn_wgmma.cuh, and its grid has a
    row of blocks for every slab of a layout whose experts' tiles each
    form one run."""
    from repro_torch.kernels.grouped_moe import ops
    R = _grouped_rows(tokens, k, E)
    plan = ops.grouped_plan(R, D, F, E, dtype, swiglu, PLAN_SMS)
    ntiles = R // 8
    elem = 4 if dtype == torch.float32 else 2
    for prod, K, N, mats in ((plan.up, D, F, 2 if swiglu else 1),
                             (plan.down, F, D, 1)):
        assert 1 <= prod.splits <= ops.MAX_CLUSTER
        assert prod.slice % prod.rows_per_stage == 0
        assert -(-K // prod.slice) == prod.splits
        assert prod.col_blocks == -(-N // prod.cols)
        assert 0 < prod.smem <= ops.SMEM_LIMIT
        if plan.path == "short":
            vec = 16 // elem
            groups = ops.SHORT_THREADS * vec // prod.cols
            assert prod.threads == ops.SHORT_THREADS
            assert prod.cols // (32 * vec) in (1, 2, 4)
            assert prod.rows_per_stage == ops.STAGE_ROWS // mats * groups
            assert prod.slice <= ops.MAX_SLICE
            assert prod.row_blocks == ntiles
            assert prod.stages == ops.RING_STAGES
            assert prod.smem >= ops.RING_BYTES + 8 * prod.slice * 4
            assert prod.smem >= groups * mats * 8 * prod.cols * 4
        else:
            mode = ("3xtf32" if elem == 4 else
                    "bf16" if prod is plan.up else "2xtf32")
            bn, bk, smem = ops._wgmma_smem(mode, mats)
            assert (prod.cols, prod.rows_per_stage, prod.smem) == (bn, bk,
                                                                  smem)
            assert prod.threads == 128
            assert prod.stages == ops.WGMMA_STAGES
            assert prod.row_blocks >= -(-ntiles // 8) + min(E, ntiles) - 1
            assert ntiles * 4 <= prod.smem - 1024
    assert plan.work_floats >= R * F + ntiles and plan.work_floats % 4 == 0
    assert len(plan.ints()) == ops.PLAN_INTS


def test_grouped_plan_reads_no_tensor(monkeypatch):
    """The plan is a function of static shapes: it takes no tensor and
    reads none (a tensor read would raise here), and equal shapes give
    equal plans."""
    import inspect

    from repro_torch.kernels.grouped_moe.ops import grouped_plan

    def refuse(*a, **kw):
        raise AssertionError("grouped_plan read a tensor")

    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__index__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    sig = inspect.signature(grouped_plan)
    assert all(p.annotation is not torch.Tensor
               and "Tensor" not in str(p.annotation)
               for p in sig.parameters.values())
    a = grouped_plan(160, 768, 3072, 4, torch.float32, False, PLAN_SMS)
    b = grouped_plan(160, 768, 3072, 4, torch.float32, False, PLAN_SMS)
    assert a == b


@pytest.mark.parametrize("N,D,E", [
    (1, 768, 4), (4, 768, 4), (4, 2048, 60), (63, 768, 128), (65, 768, 60),
    (100, 2048, 60), (1024, 768, 4), (1024, 2048, 60), (4096, 2048, 128),
    (5, 20, 3)])
def test_router_plan_covers_the_tokens_and_rows(N, D, E):
    """B1's one launch: tiles of whole micro-tiles whose logits fit in
    shared memory, slices of D in whole staged chunks that cover D with
    no empty slice, and no more blocks than SMs once there are tiles
    enough to fill them."""
    from repro_torch.kernels.router_topk.ops import (DC, LG_FLOATS,
                                                     MAX_SLICES, MAX_TILE,
                                                     router_plan)
    p = router_plan(N, D, E, PLAN_SMS)
    E4 = -(-E // 4) * 4
    assert p.tile % 4 == 0 and 4 <= p.tile <= MAX_TILE
    assert p.tile * E4 <= LG_FLOATS
    assert p.slice_len % DC == 0
    assert p.slices * p.slice_len >= D > (p.slices - 1) * p.slice_len
    nt = p.ntiles(N)
    assert nt == -(-N // p.tile)
    assert nt * p.slices <= max(PLAN_SMS, nt)
    assert p.slices <= MAX_SLICES
    if N <= 4 and D >= 2 * DC:   # decode: one tile, W over several blocks
        assert nt == 1 and p.slices > 1
