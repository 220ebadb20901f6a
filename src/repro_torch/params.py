"""Weight bridge: the reference's numpy parameter tree -> torch tensors.

The reference keeps parameters as nested dicts of arrays with the block
parameters stacked along a leading ``num_blocks`` axis under
``params["blocks"]["pos{p}"]``. The port uses the same keys and the
same layouts (weights ``(in, out)``, computed as ``x @ w``), so a tree of
numpy arrays converts leaf by leaf::

    np_tree = jax.tree.map(np.asarray, Model(cfg).init_params(key))
    params = params_from_numpy(np_tree, device="cpu")
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every non-dict leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> Iterator[Any]:
    """The non-dict leaves of a nested dict, in key order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def params_from_numpy(tree: Dict[str, Any],
                      device: DeviceLike = None) -> Dict[str, Any]:
    """Convert a nested dict of numpy arrays to torch tensors on ``device``
    (CUDA unless given), keeping keys, shapes and dtypes."""
    dev = resolve_device(device)

    def leaf(a: Any) -> torch.Tensor:
        arr = np.asarray(a)
        if arr.dtype.name == "bfloat16":      # ml_dtypes scalar type
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))   # a writable copy
        return t.to(dev)

    return tree_map(leaf, tree)
