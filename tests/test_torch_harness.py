"""Shared pieces of the PyTorch port's parity tests, and the tests of the
configuration copy and the weight bridge.

Both packages are built from the same reduced configuration; weights come
from the reference's ``Model.init_params`` and reach the port through
``repro_torch.params.params_from_numpy``; inputs are drawn with
``numpy.random.default_rng``. JAX stays on the CPU and data crosses
between the two as numpy arrays. The port runs with ``device="cpu"``, so
every kernel wrapper takes its plain PyTorch version.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.config import reduced_config as jax_reduced_config
from repro.models import Model as JaxModel
from repro_torch.config import get_arch, reduced_config
from repro_torch.models import Model
from repro_torch.params import params_from_numpy, tree_map

PORT_ARCHS = ("gpt2-moe", "qwen2-moe-a2.7b")
CPU = "cpu"


@pytest.fixture
def cuda():
    """The CUDA device for tests marked ``gpu``; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@functools.lru_cache(maxsize=None)
def model_pair(name: str, seed: int = 0):
    """(jax cfg, jax model, jax params, port cfg, port model, port params)
    for the reduced ``name``, same weights on both sides."""
    cfg_j = jax_reduced_config(jax_get_arch(name))
    cfg_t = reduced_config(get_arch(name))
    jm = JaxModel(cfg_j, moe_executor="grouped")
    tm = Model(cfg_t, device=CPU, moe_executor="grouped")
    pj = jm.init_params(jax.random.PRNGKey(seed))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device=CPU)
    return cfg_j, jm, pj, cfg_t, tm, pt


def block0_moe(name: str):
    """Block 0's MoE params on both sides (jax tree, port tree)."""
    _, _, pj, _, _, pt = model_pair(name)
    mj = jax.tree.map(lambda a: a[0], pj["blocks"]["pos0"]["moe"])
    mt = {k: (v[0] if torch.is_tensor(v) else {kk: vv[0]
                                               for kk, vv in v.items()})
          for k, v in pt["blocks"]["pos0"]["moe"].items()}
    return mj, mt


def np_(x):
    """A jax array, torch tensor or nested NamedTuple leaf -> numpy."""
    if torch.is_tensor(x):
        return x.detach().cpu().float().numpy() if x.is_floating_point() \
            else x.detach().cpu().numpy()
    return np.asarray(x)


def t_(a, dtype=None):
    """numpy -> CPU tensor (optionally cast)."""
    t = torch.from_numpy(np.array(a))   # a writable copy
    return t.to(dtype) if dtype is not None else t


def params_to_numpy(tree):
    """Port params -> float32/int numpy arrays, same keys."""
    return tree_map(np_, tree)


# ---------------------------------------------------------------- the tests

@pytest.mark.parametrize("name", PORT_ARCHS)
def test_config_copy_matches_reference(name):
    """The port's configs and ``reduced_config`` equal the reference's,
    field by field, at full size and reduced."""
    for full in (False, True):
        cj = jax_get_arch(name) if full else jax_reduced_config(
            jax_get_arch(name))
        ct = get_arch(name) if full else reduced_config(get_arch(name))
        dj, dt = dataclasses.asdict(cj), dataclasses.asdict(ct)
        assert dj == dt


def test_registry_holds_only_ported_archs():
    with pytest.raises(KeyError, match="ROADMAP.md"):
        get_arch("zamba2-7b")


@pytest.mark.parametrize("name", PORT_ARCHS)
def test_params_bridge_keeps_keys_shapes_and_values(name):
    _, _, pj, cfg, _, pt = model_pair(name)
    flat_j = jax.tree_util.tree_flatten_with_path(pj)[0]
    back = params_to_numpy(pt)
    for path, leaf in flat_j:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert pt["blocks"]["pos0"]["attn"]["wq"].shape[0] == cfg.num_blocks


@pytest.mark.parametrize("name", PORT_ARCHS)
def test_port_init_params_matches_reference_layout(name):
    """``Model.init_params`` (torch generator) builds the reference's tree:
    same keys, shapes and dtypes, stacked over blocks."""
    _, _, pj, _, tm, _ = model_pair(name)
    pt = tm.init_params(torch.Generator().manual_seed(0))
    shapes_j = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), pj)
    shapes_t = jax.tree.map(lambda a: (tuple(a.shape), "float32"),
                            params_to_numpy(pt))
    assert shapes_j == shapes_t
    pb = tm.init_params(torch.Generator().manual_seed(0), torch.bfloat16)
    assert pb["embed"].dtype == torch.bfloat16
