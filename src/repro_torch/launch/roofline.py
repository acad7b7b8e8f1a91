"""Roofline of one step on one H100 from the dry run's counts (no card
needed): the counterpart of ``repro/launch/roofline.py``.

Two terms per cell on one card, in seconds:

    compute = flops / PEAK_FLOPS_BF16
    memory  = hbm_bytes / HBM_BW

``flops`` is what ``torch.utils.flop_counter.FlopCounterMode`` counts:
only the operators that have a formula (``mm``, ``bmm``, ``addmm``,
``baddbmm``, convolutions, SDPA, and the flash operator
``repro_torch::flash_attention``), where XLA's cost analysis also counts
element-wise work; so ``useful_flops_frac`` here is the port's own figure,
not comparable with the reference's.  ``hbm_bytes`` is the eager
program's traffic, every dispatched operator's inputs and outputs
(``launch/dryrun.py``), which exceeds XLA's count over fused kernels.

On a mesh (``launch/dryrun.py --mesh``) a third term reads the
collective bytes that ``launch/shardings.py``'s counter gives for one
rank of the traced step, each collective's result bytes as the
reference's ``parse_collective_bytes`` counts them, times the chips:

    collective = coll_bytes / (chips * LINK_BW)

``LINK_BW`` is a data-sheet figure, not measured: H100 SXM NVLink 4,
900 GB/s both ways, so 450e9 B/s each way, in the part of the reference's
per-link ``ICI_BW``.  The port's one-card terms have ``collective_s`` 0:
its simulated ``all_to_all`` is a device-local transpose whose bytes are
HBM bytes.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Union

import torch

# H100 SXM (NVIDIA data sheet): the dense bf16 tensor-core rate and the
# HBM3 bandwidth
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
#: H100 SXM NVLink 4 (NVIDIA data sheet): 900 GB/s both ways, 450e9 B/s
#: each way; the collective term's rate (the reference's ``ICI_BW``)
LINK_BW = 450e9
#: ``torch.cuda.get_device_properties(0).total_memory`` of an "NVIDIA H100
#: 80GB HBM3" (power limit 700.00 W), read by ``chip_smoke.py``: what the
#: dry run's ``fits`` divides by where no card is present
HBM_BYTES = 85017493504

Tensors = Union[Mapping[str, torch.Tensor], Iterable[torch.Tensor]]


def _tensors(params: Tensors):
    return params.values() if isinstance(params, Mapping) else params


def param_count(params: Tensors) -> int:
    """Elements over ``params`` (a name -> tensor mapping, or tensors)."""
    return sum(int(t.numel()) for t in _tensors(params))


def active_param_count(cfg, named_params: Mapping[str, torch.Tensor]) -> int:
    """Parameters a token meets: every routed expert's weights
    (``*.moe.{wi,wg,wo}``) count ``topk / n_experts`` of their size, since
    each token activates ``topk`` of ``n_experts``; everything else counts
    whole, the always-active shared experts (``*.moe.shared.*``) included.
    The reference scales the shared experts by ``topk / n_experts`` too
    (its rule matches any ``moe`` path holding ``wi|wg|wo``,
    ``repro/launch/roofline.py:108-120``), against its own docstring."""
    total = 0
    for name, t in named_params.items():
        n = int(t.numel())
        parts = name.split(".")
        if "moe" in parts and "shared" not in parts and parts[-1] in ("wi", "wg", "wo"):
            n = n * max(1, cfg.topk) // max(1, cfg.n_experts)
        total += n
    return total


def model_flops_train(n_active: int, tokens: int) -> float:
    return 6.0 * n_active * tokens


def model_flops_decode(n_active: int, tokens: int) -> float:
    return 2.0 * n_active * tokens  # forward only, one token per sequence


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float = 0.0, chips: int = 1, *,
                   model_flops: Optional[float] = None) -> Dict[str, float]:
    """``compute_s``, ``memory_s``, ``collective_s``, the ``dominant`` term
    and ``bound_s`` (the largest); with ``model_flops`` also
    ``useful_flops_frac`` (model over counted flops) and ``roofline_frac``
    (the model flops' time at the peak over ``bound_s``).  ``flops``,
    ``hbm_bytes`` and ``coll_bytes`` are global: one rank's times
    ``chips``, as the reference scales them."""
    compute = flops / (chips * PEAK_FLOPS_BF16)
    memory = hbm_bytes / (chips * HBM_BW)
    collective = coll_bytes / (chips * LINK_BW)
    terms: Dict[str, float] = {"compute_s": compute, "memory_s": memory, "collective_s": collective}
    terms["dominant"] = max(terms, key=terms.get)
    terms["bound_s"] = bound = max(compute, memory, collective)
    if model_flops is not None and flops > 0:
        terms["model_flops"] = model_flops
        terms["useful_flops_frac"] = model_flops / flops
        terms["roofline_frac"] = (model_flops / (chips * PEAK_FLOPS_BF16)) / bound if bound > 0 else 0.0
    return terms
