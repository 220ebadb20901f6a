"""The port's hand-written kernels against their plain versions on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The
module imports torch, numpy and ``repro_torch`` only (the GPU machine has
no JAX), so it runs there without the repository's ``conftest.py``::

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_gpu.py

Each test also checks that the wrapper's launch counter rose, so a plain
version standing in on the card would fail. Integers compare exactly;
floats within the kernel harness's bounds (f32 3e-5, bf16 2e-2), the
router's float outputs within 1e-5. The input builders are shared with
the CPU parity tests (``tests/test_torch_kernels.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (device_ops_per_call, launch_counts,
                                 reset_launch_counts, workspace_is_zero)
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                     kv_splits)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.expert_ffn.ops import capacity_ffn
from repro_torch.kernels.expert_ffn.ref import capacity_ffn_ref
from repro_torch.kernels._common import sm_count
from repro_torch.kernels.grouped_moe import ops as grouped_ops
from repro_torch.kernels.grouped_moe.ops import grouped_moe_ffn
from repro_torch.kernels.grouped_moe.ref import grouped_moe_ref
from repro_torch.kernels.router_topk.ops import router_topk, router_topk_fused
from repro_torch.kernels.router_topk.ref import (router_topk_fused_ref,
                                                 router_topk_ref)

TOL = {torch.float32: dict(rtol=3e-5, atol=3e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    """The CUDA device, full-float32 products; skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def to_np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy()


def on(a, dev, dtype=None):
    t = torch.from_numpy(np.array(a)).to(dev)
    return t.to(dtype) if dtype is not None else t


# ------------------------------------------------------------ input builders

def router_inputs(N, D, E, *, seed=0, case="random"):
    """x (N, D), W (D, E) float32. ``tie``: experts 1 and 2 lead for every
    token with identical columns (equal logits bit for bit);
    ``all-to-one``: every token's top choice is the last expert."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    w = (rng.normal(size=(D, E)) / np.sqrt(D)).astype(np.float32)
    if case in ("tie", "all-to-one"):
        x[:, 0] = np.abs(x[:, 0]) + 0.5        # feature 0 positive
        w[0, :] = -10.0
    if case == "tie":
        w[0, 1] = 5.0
        w[:, 2] = w[:, 1]
    elif case == "all-to-one":
        w[0, E - 1] = 5.0
    return x, w


ROUTER_CASES = [
    # N, D, E, k, valid_experts, case, block_n of the Pallas kernel
    (64, 48, 4, 1, None, "random", 64),          # gpt2-moe routing
    (100, 48, 60, 4, None, "random", 64),        # qwen2-moe, padded rows
    (130, 32, 8, 2, 6, "random", 32),            # padded rows + masked E
    (96, 32, 8, 2, None, "tie", 32),
    (40, 32, 16, 4, None, "all-to-one", 16),
]


def grouped_inputs(counts, D, F, *, seed=0, rows=8):
    """The sorted ragged-group layout for per-expert pair counts: random
    real rows, zero group padding, ``tile_expert`` per 8-row tile, and a
    trailing all-zero tile as the static worst-case buffer has them."""
    rng = np.random.default_rng(seed)
    E = len(counts)
    blocks, tiles = [], []
    for e, c in enumerate(counts):
        if c == 0:
            continue
        pad = (-c) % rows
        blocks.append(0.5 * rng.normal(size=(c, D)))
        blocks.append(np.zeros((pad, D)))
        tiles += [e] * ((c + pad) // rows)
    blocks.append(np.zeros((rows, D)))
    tiles.append(E - 1)
    x = np.concatenate(blocks).astype(np.float32)
    # fan-in scaled, so activations stay O(1) at any width
    wg = (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32)
    wu = (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32)
    wd = (rng.normal(size=(E, F, D)) / np.sqrt(F)).astype(np.float32)
    return x, np.asarray(tiles, np.int32), wg, wu, wd


GROUPED_CASES = [
    ((8, 8, 8, 8), "balanced"),
    ((41, 17, 9, 5, 3, 2, 2, 1), "skewed"),
    ((0, 64, 0, 0), "all-to-one"),
    ((27, 3, 1, 0, 0, 1), "empty-groups"),
]


def capacity_inputs(E, C, D, F, *, seed=0, zero=False):
    """Dense capacity buffers (E, C, D) as the dense executor fills them:
    random rows, the last quarter of each expert's slots empty (zero), or
    every slot empty under ``zero``; fan-in scaled expert weights."""
    rng = np.random.default_rng(seed)
    buf = 0.5 * rng.normal(size=(E, C, D))
    buf[:, C - C // 4:] = 0.0
    if zero:
        buf[:] = 0.0
    wg = rng.normal(size=(E, D, F)) / np.sqrt(D)
    wu = rng.normal(size=(E, D, F)) / np.sqrt(D)
    wd = rng.normal(size=(E, F, D)) / np.sqrt(F)
    return tuple(a.astype(np.float32) for a in (buf, wg, wu, wd))


CAPACITY_CASES = [
    # E, C, D, F, label: aligned, ragged C and F, C = 12 (8 < C < 64),
    # C < 8, F not a multiple of 64, and an all-zero buffer
    (4, 128, 64, 128, "aligned"),
    (3, 72, 48, 40, "ragged"),
    (3, 12, 16, 24, "C12"),
    (3, 5, 16, 24, "C5"),
    (2, 64, 96, 1000, "F1000"),
    (2, 64, 32, 64, "zero"),
]


def decode_inputs(B, N, G, D, T, *, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, N, G, D)).astype(np.float32)
    k = rng.normal(size=(B, T, N, D)).astype(np.float32)
    v = rng.normal(size=(B, T, N, D)).astype(np.float32)
    return q, k, v


DECODE_CASES = [
    # B, N, G, D, T (cache), kv_len (ragged slice), valid_len
    (4, 2, 1, 64, 128, 48, (1, 17, 40, 48)),      # serving shape, G=1
    (2, 2, 4, 32, 96, 96, (96, 50)),               # GQA, G=4
    (3, 1, 2, 32, 640, 512, (5, 300, 512)),        # long + ragged
    (2, 2, 2, 32, 64, 40, (0, 17)),                # a row with no valid slot
]


# the kernels' other paths: B4 split along K (the runtime's calibration
# shape) and rows that are not whole 16-byte chunks (element-wise
# staging); B3 split along the cache, a valid length that ends on a chunk
# edge (chunks of 32), and rows that are not whole 16-byte chunks
CAPACITY_PATH_CASES = [
    (4, 64, 768, 3072, "calibrate-split-k"),
    (2, 20, 36, 70, "unaligned-rows"),
]
DECODE_PATH_CASES = [
    (1, 2, 1, 128, 4096, 4096, (3000,), "split-kv"),
    (2, 2, 1, 64, 128, 96, (64, 32), "chunk-edge"),
    (2, 2, 2, 34, 64, 40, (33, 7), "unaligned-rows"),
]


# --------------------------------------------------------------------- tests

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,D,E,k,ve,case,block_n", ROUTER_CASES)
def test_router_kernel_matches_plain_on_card(cuda, N, D, E, k, ve, case,
                                             block_n, dtype):
    tdt = TORCH_DTYPES[dtype]
    x, w = router_inputs(N, D, E, case=case)
    xc, wc = on(x, cuda, tdt), on(w, cuda, tdt)
    reset_launch_counts()
    got = router_topk_fused(xc, wc, k=k, valid_experts=ve)
    assert launch_counts()["router_topk_fused"] == 1
    want = router_topk_fused_ref(xc, wc, k=k, valid_experts=ve)
    torch.cuda.synchronize()
    for g, wv in zip(got, want):
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(to_np(g), to_np(wv))
        else:
            np.testing.assert_allclose(to_np(g), to_np(wv), rtol=1e-5,
                                       atol=1e-5)
    if case == "tie":
        assert (to_np(got[1])[:, :2] == [1, 2]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,D,E,k,ve,case,block_n", ROUTER_CASES)
def test_gating_router_kernel_matches_plain_on_card(cuda, N, D, E, k, ve,
                                                    case, block_n, dtype):
    """B5: one launch of the gate kernel; the fused router is not run."""
    tdt = TORCH_DTYPES[dtype]
    x, w = router_inputs(N, D, E, case=case)
    xc, wc = on(x, cuda, tdt), on(w, cuda, tdt)
    reset_launch_counts()
    got = router_topk(xc, wc, k=k, valid_experts=ve)
    counts = launch_counts()
    assert counts["router_topk"] == 1 and counts["router_topk_fused"] == 0
    want = router_topk_ref(xc, wc, k=k, valid_experts=ve)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(to_np(got[1]), to_np(want[1]))
    np.testing.assert_allclose(to_np(got[0]), to_np(want[0]), rtol=1e-5,
                               atol=1e-5)
    if case == "tie":
        assert (to_np(got[1])[:, :2] == [1, 2]).all()
    if ve is not None:
        assert (to_np(got[1]) < ve).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
@pytest.mark.parametrize("E,C,D,F,label", CAPACITY_CASES,
                         ids=[c[-1] for c in CAPACITY_CASES])
def test_capacity_kernel_matches_plain_on_card(cuda, E, C, D, F, label,
                                               activation, dtype):
    """B4: ragged C, D and F are handled inside the kernel; empty slots
    come out as exact zeros."""
    tdt = TORCH_DTYPES[dtype]
    buf, wg, wu, wd = capacity_inputs(E, C, D, F, zero=label == "zero")
    wu_c = on(wu, cuda, tdt) if activation == "swiglu" else None
    args = (on(buf, cuda, tdt), on(wg, cuda, tdt), wu_c, on(wd, cuda, tdt))
    reset_launch_counts()
    got = capacity_ffn(*args, activation=activation)
    assert launch_counts()["capacity_ffn"] == 1
    want = capacity_ffn_ref(*args, activation=activation)
    torch.cuda.synchronize()
    assert got.dtype == tdt and got.shape == (E, C, D)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL[tdt])
    empty = ~buf.any(-1)
    assert not to_np(got)[empty].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
@pytest.mark.parametrize("D,F", [(96, 160), (704, 1000)])
@pytest.mark.parametrize("counts,label", GROUPED_CASES,
                         ids=[c[1] for c in GROUPED_CASES])
def test_grouped_kernel_matches_plain_on_card(cuda, counts, label, D, F,
                                              activation, dtype):
    """(704, 1000): reduction slices that do not divide D or F."""
    tdt = TORCH_DTYPES[dtype]
    x, te, wg, wu, wd = grouped_inputs(counts, D, F)
    wu_c = on(wu, cuda, tdt) if activation == "swiglu" else None
    args = (on(x, cuda, tdt), on(te, cuda), on(wg, cuda, tdt), wu_c,
            on(wd, cuda, tdt))
    reset_launch_counts()
    got = grouped_moe_ffn(*args, activation=activation)
    assert launch_counts()["grouped_moe_ffn"] == 1
    want = grouped_moe_ref(*args, activation=activation)
    torch.cuda.synchronize()
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL[tdt])
    assert not to_np(got)[-8:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,G,D,T,kv_len,valid", DECODE_CASES)
def test_decode_kernel_matches_plain_on_card(cuda, B, N, G, D, T, kv_len,
                                             valid, dtype):
    tdt = TORCH_DTYPES[dtype]
    q, k, v = decode_inputs(B, N, G, D, T)
    qc, kc, vc = (on(a, cuda, tdt) for a in (q, k, v))
    vl = on(np.asarray(valid, np.int32), cuda)
    reset_launch_counts()
    got = decode_attention(qc, kc[:, :kv_len], vc[:, :kv_len], vl)
    assert launch_counts()["decode_attention"] == 1
    want = decode_attention_ref(qc, kc[:, :kv_len], vc[:, :kv_len], vl)
    torch.cuda.synchronize()
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL[tdt])


@pytest.mark.gpu
@pytest.mark.parametrize("collect_telemetry", [True, False])
def test_serving_engine_runs_through_the_kernels(cuda, collect_telemetry):
    """A reduced gpt2-moe served on the card: every request finishes, and
    the router and grouped kernels (and, with telemetry off, flash-decode)
    were launched."""
    from repro_torch import Model, ServingEngine, get_arch, reduced_config
    cfg = reduced_config(get_arch("gpt2-moe"))
    model = Model(cfg, moe_executor="grouped")
    params = model.init_params(torch.Generator(cuda).manual_seed(0))
    eng = ServingEngine(model, params, max_len=32, batch_size=2,
                        collect_telemetry=collect_telemetry)
    rng = np.random.default_rng(0)
    for n in (5, 9, 3):
        eng.submit(rng.integers(0, cfg.vocab_size, n), max_new_tokens=4)
    reset_launch_counts()
    done = eng.run()
    counts = launch_counts()
    assert [r.finish_reason for r in done] == ["length"] * 3
    assert counts["router_topk_fused"] > 0 and counts["grouped_moe_ffn"] > 0
    assert (counts["decode_attention"] > 0) == (not collect_telemetry)


@pytest.mark.gpu
def test_runtime_profiles_through_the_dense_kernels(cuda):
    """A reduced gpt2-moe runtime on the card: calibration launches the
    capacity FFN kernel, and each capture forward launches it and the
    fused router once per layer."""
    from repro_torch.core.runtime import RuntimeConfig, ServerlessMoERuntime
    reset_launch_counts()
    rt = ServerlessMoERuntime(RuntimeConfig(
        arch="gpt2-moe", batch_size=2, seq_len=16, profile_batches=2,
        learn_batches=1, eval_batches=1))
    assert launch_counts()["capacity_ffn"] == 6     # warm-up + 5 timed
    reset_launch_counts()
    table = rt.profile_table()
    counts = launch_counts()
    L = rt.num_layers
    assert counts["capacity_ffn"] == counts["router_topk_fused"] == 2 * L
    demand = sum(rt.real_demand(b["tokens"])
                 for b in rt.corpus.batches(2))
    assert demand.sum() == 2 * 2 * 16 * rt.top_k * L
    assert len(table.counts) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
@pytest.mark.parametrize("E,C,D,F,label", CAPACITY_PATH_CASES,
                         ids=[c[-1] for c in CAPACITY_PATH_CASES])
def test_capacity_kernel_paths_repeat_bit_for_bit(cuda, E, C, D, F, label,
                                                  activation, dtype):
    """B4's split-K and element-wise paths agree with the plain version,
    and two calls on the same inputs give the same bits (the split
    partials are summed in a fixed order, no atomics)."""
    tdt = TORCH_DTYPES[dtype]
    buf, wg, wu, wd = capacity_inputs(E, C, D, F)
    wu_c = on(wu, cuda, tdt) if activation == "swiglu" else None
    args = (on(buf, cuda, tdt), on(wg, cuda, tdt), wu_c, on(wd, cuda, tdt))
    reset_launch_counts()
    got = capacity_ffn(*args, activation=activation)
    again = capacity_ffn(*args, activation=activation)
    assert launch_counts()["capacity_ffn"] == 2
    want = capacity_ffn_ref(*args, activation=activation)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL[tdt])
    assert not to_np(got)[~buf.any(-1)].any()


@pytest.mark.gpu
def test_capacity_bf16_down_product_takes_h_in_float32(cuda):
    """In bfloat16 the down product reads h in float32, as the Pallas
    kernel does: the kernel's bf16 output matches the plain version (h in
    float32) bit for bit almost everywhere, and a version that rounds h to
    bf16 first visibly less often."""
    buf, wg, wu, wd = capacity_inputs(4, 64, 256, 512)
    args = tuple(on(a, cuda, torch.bfloat16) for a in (buf, wg, wu, wd))
    got = capacity_ffn(*args, activation="swiglu")
    want = capacity_ffn_ref(*args, activation="swiglu")
    x, g, u, d = (a.float() for a in args)
    h16 = (torch.nn.functional.silu(torch.bmm(x, g)) * torch.bmm(x, u)
           ).to(torch.bfloat16).float()
    want_h16 = torch.bmm(h16, d).to(torch.bfloat16)
    torch.cuda.synchronize()
    rows = torch.from_numpy(buf.any(-1)).to(cuda)
    same = (got == want)[rows].float().mean().item()
    same_h16 = (got == want_h16)[rows].float().mean().item()
    assert same > 0.95 and same > same_h16 + 0.1, (same, same_h16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,G,D,T,kv_len,valid,label", DECODE_PATH_CASES,
                         ids=[c[-1] for c in DECODE_PATH_CASES])
def test_decode_kernel_paths_repeat_bit_for_bit(cuda, B, N, G, D, T, kv_len,
                                                valid, label, dtype):
    """B3's split-KV merge (in split order, inside the one launch), a
    chunk-edge valid length and element-wise staging agree with the plain
    version; two calls give the same bits."""
    tdt = TORCH_DTYPES[dtype]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert (kv_splits(B, N, kv_len, sms) > 1) == (label == "split-kv")
    q, k, v = decode_inputs(B, N, G, D, T)
    qc, kc, vc = (on(a, cuda, tdt) for a in (q, k, v))
    vl = on(np.asarray(valid, np.int32), cuda)
    args = (qc, kc[:, :kv_len], vc[:, :kv_len], vl)
    reset_launch_counts()
    got = decode_attention(*args)
    again = decode_attention(*args)
    assert launch_counts()["decode_attention"] == 2
    want = decode_attention_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL[tdt])


# ------------------------------- B1 in one launch; B2 at more layouts

# B1 at every token count the plan treats differently (one tile and many
# slices; a tile edge at 64; many tiles), at gpt2-moe's, qwen2-moe's and
# the widest expert count, and ties
ROUTER_LAUNCH_CASES = [
    (N, E, k, "random") for N in (1, 4, 63, 64, 65, 100, 1024, 4096)
    for E, k in ((4, 1), (60, 4), (128, 8))
] + [(4, 60, 4, "tie"), (1024, 60, 4, "tie"), (65, 8, 2, "tie")]


def repeat_and_count_checks(fn, ops: int):
    """Two calls give equal bits, the ticket workspace is zero after them,
    and a call puts exactly ``ops`` CUDA operations on the device."""
    first = fn()
    second = fn()
    torch.cuda.synchronize()
    first = first if isinstance(first, tuple) else (first,)
    second = second if isinstance(second, tuple) else (second,)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert workspace_is_zero()
    assert device_ops_per_call(fn) == ops
    assert workspace_is_zero()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,E,k,case", ROUTER_LAUNCH_CASES)
def test_router_kernel_is_one_launch_at_every_size(cuda, N, E, k, case,
                                                   dtype):
    """B1 in one launch: partial logits over slices of D and tiles of
    tokens merged inside it (by tickets); integers exact, floats within
    1e-5, repeatable bits, one CUDA operation per call."""
    tdt = TORCH_DTYPES[dtype]
    x, w = router_inputs(N, 768, E, case=case)
    xc, wc = on(x, cuda, tdt), on(w, cuda, tdt)
    reset_launch_counts()
    got = router_topk_fused(xc, wc, k=k)
    assert launch_counts()["router_topk_fused"] == 1
    want = router_topk_fused_ref(xc, wc, k=k)
    torch.cuda.synchronize()
    for g, wv in zip(got, want):
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(to_np(g), to_np(wv))
        else:
            np.testing.assert_allclose(to_np(g), to_np(wv), rtol=1e-5,
                                       atol=1e-5)
    if case == "tie":
        assert (to_np(got[1])[:, :2] == [1, 2]).all()
    repeat_and_count_checks(lambda: router_topk_fused(xc, wc, k=k), 1)
    repeat_and_count_checks(lambda: router_topk(xc, wc, k=k), 1)


def routed_counts(N, E, k, seed=0):
    """Per-expert pair counts of N tokens routed top-k at random."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(E, k, replace=False) for _ in range(N)])
    return tuple(int(c) for c in np.bincount(idx.ravel(), minlength=E))


def grouped_device_inputs(counts, D, F, dev, dtype, seed=0):
    """``grouped_inputs`` with the weights drawn on the card (qwen2-moe's
    60 experts are 2 GB in float32)."""
    x, te, _, _, _ = grouped_inputs(counts, 8, 8, seed=seed)
    rng = np.random.default_rng(seed)
    x = np.zeros((x.shape[0], D), np.float32)
    row = 0
    for c in counts:
        if c:
            x[row:row + c] = 0.5 * rng.normal(size=(c, D))
            row += -(-c // 8) * 8
    g = torch.Generator(dev).manual_seed(seed)
    E = len(counts)
    wg = torch.randn(E, D, F, generator=g, device=dev) / D ** 0.5
    wu = torch.randn(E, D, F, generator=g, device=dev) / D ** 0.5
    wd = torch.randn(E, F, D, generator=g, device=dev) / F ** 0.5
    return (on(x, dev, dtype), on(te, dev), wg.to(dtype), wu.to(dtype),
            wd.to(dtype))


# B2 at the layouts an expert-major design would treat apart: an expert
# with many tiles at gpt2-moe width; all pairs in one expert with the
# tail tile's label (E-1) idle and live; qwen2-moe's widths; rows that
# are not whole 16-byte chunks; then the layouts the two paths of the
# Hopper design treat apart: one expert with 31-200 rows (around the
# tensor-core path's threshold and its 64-row slab; the tail tile is an
# all-zero run of its own), a long run followed directly by the next
# expert's rows (the next expert's rows inside a slab), a tile with one
# live row among seven zero rows, and the 512-token gpt2-moe and
# 128-token qwen2-moe layouts
GROUPED_LAUNCH_CASES = [
    (routed_counts(128, 4, 1), 768, 3072, "gpt2-N128-top1"),
    ((0, 64, 0, 0), 768, 3072, "all-to-one-tail-idle"),
    ((0, 0, 0, 64), 768, 3072, "all-to-one-tail-live"),
    (routed_counts(16, 60, 4), 2048, 1408, "qwen2-N16-top4"),
    ((5, 0, 13, 2), 36, 70, "odd-widths"),
    *(((n, 0), 768, 3072, f"one-expert-{n}-rows")
      for n in (31, 32, 33, 63, 64, 65, 200)),
    ((70, 50, 0, 3), 768, 3072, "long-run-then-next-expert"),
    ((1, 0, 9, 0), 768, 3072, "one-live-row-in-tile"),
    (routed_counts(512, 4, 1), 768, 3072, "gpt2-N512-top1"),
    (routed_counts(128, 60, 4), 2048, 1408, "qwen2-N128-top4"),
]


def check_grouped_layout(dev, counts, D, F, activation, dtype):
    """B2 (an up and a down launch, split merges inside clusters): matches
    the plain version, repeatable bits, the padding and tail rows exactly
    zero, two CUDA operations per call."""
    tdt = TORCH_DTYPES[dtype]
    x, te, wg, wu, wd = grouped_device_inputs(counts, D, F, dev, tdt)
    args = (x, te, wg, wu if activation == "swiglu" else None, wd)
    reset_launch_counts()
    got = grouped_moe_ffn(*args, activation=activation)
    assert launch_counts()["grouped_moe_ffn"] == 1
    want = grouped_moe_ref(*args, activation=activation)
    torch.cuda.synchronize()
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL[tdt])
    assert not to_np(got)[~to_np(x).any(-1)].any()
    repeat_and_count_checks(lambda: grouped_moe_ffn(*args,
                                                 activation=activation), 2)
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
@pytest.mark.parametrize("counts,D,F,label", GROUPED_LAUNCH_CASES,
                         ids=[c[-1] for c in GROUPED_LAUNCH_CASES])
def test_grouped_kernel_at_serving_layouts(cuda, counts, D, F, label,
                                           activation, dtype):
    """B2 on the path its plan picks."""
    check_grouped_layout(cuda, counts, D, F, activation, dtype)


@pytest.fixture(params=["short", "long"])
def grouped_path(request, monkeypatch):
    """B2's plan held to one path: the tensor cores' threshold of mean
    rows per expert set to 0 (long) or past any layout (short)."""
    monkeypatch.setattr(grouped_ops, "LONG_ROWS",
                        0 if request.param == "long" else 1 << 30)
    grouped_ops._plan_ints.cache_clear()
    yield request.param
    grouped_ops._plan_ints.cache_clear()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
@pytest.mark.parametrize("counts,D,F,label", GROUPED_LAUNCH_CASES,
                         ids=[c[-1] for c in GROUPED_LAUNCH_CASES])
def test_grouped_kernel_on_both_paths(cuda, grouped_path, counts, D, F,
                                      label, activation, dtype):
    """Every layout on the short path (CUDA cores) and on the long one
    (tensor cores; rows that are not whole 16-byte chunks stay short)."""
    x = check_grouped_layout(cuda, counts, D, F, activation, dtype)
    E, elem = len(counts), x.element_size()
    plan = grouped_ops.grouped_plan(x.shape[0], D, F, E, x.dtype,
                                    activation == "swiglu", sm_count(cuda))
    aligned = (D * elem) % 16 == 0 and (F * elem) % 16 == 0
    assert plan.path == (grouped_path if aligned else "short")
