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

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.grouped_moe.ops import grouped_moe_ffn
from repro_torch.kernels.grouped_moe.ref import grouped_moe_ref
from repro_torch.kernels.router_topk.ops import router_topk_fused
from repro_torch.kernels.router_topk.ref import router_topk_fused_ref

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
