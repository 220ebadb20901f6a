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

from test_torch_gpu import (DECODE_CASES, GROUPED_CASES, ROUTER_CASES,
                            decode_inputs, grouped_inputs, router_inputs)
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


# the card's "skewed" counts become a Zipf draw of the reference's traces
CPU_GROUPED_CASES = [c for c in GROUPED_CASES if c[1] != "skewed"] + [
    (zipf_counts(40, 8, 2), "zipf")]


@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
@pytest.mark.parametrize("counts,label", CPU_GROUPED_CASES,
                         ids=[c[1] for c in CPU_GROUPED_CASES])
def test_grouped_plain_matches_pallas(counts, label, activation):
    jdt, tdt = jnp.float32, torch.float32
    x, te, wg, wu, wd = grouped_inputs(counts, 32, 48)
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


# ----------------------------------------------------------- flash-decode

@pytest.mark.parametrize("B,N,G,D,T,kv_len,valid", DECODE_CASES)
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
