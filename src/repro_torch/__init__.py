"""PyTorch/CUDA port of the serverless-MoE system: the serving path and
the paper's runtime loop (:mod:`repro_torch.core.runtime`: profile,
predict, ODS/BO plan, bill, serve, re-plan).

A second package beside the JAX reference ``repro``: it imports torch and
numpy only, never ``jax`` and nothing under ``repro``. Module names and
tensor layouts follow the reference (weights ``(in, out)`` computed as
``x @ w``; block parameters stacked along a leading ``num_blocks`` axis),
so each function's counterpart is found by path. Entry points run on the
CUDA device unless the caller passes ``device="cpu"``; with no device and
no GPU they raise. The hand-written Hopper kernels live in
:mod:`repro_torch.kernels`.
"""
from repro_torch.config import ModelConfig, get_arch, reduced_config  # noqa: F401
from repro_torch.models import Model  # noqa: F401
from repro_torch.params import params_from_numpy  # noqa: F401
from repro_torch.serving import ServingEngine  # noqa: F401
