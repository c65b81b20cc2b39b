"""Tensor-parallel placements of a Uformer's parameters, counterpart of
`uformer_tpu/parallel/sharding_rules.py`.

JAX's rule: replicate everything, or with a 'model' axis of size n > 1
split the 2-D Dense kernels Megatron-style: the first projection of an
FFN or of q/kv by columns (output features), the second by rows (input
features). Here the same choice per parameter of the port's model, under
the reference's state_dict keys: "column" splits a torch Linear weight
(out, in) along dim 0, "row" along dim 1, "replicate" keeps it whole.

JAX names linear1 and linear2 among its parents, but its LeFF holds them
as flat `linear1_kernel` leaves that the rule never reaches, so LeFF's
products stay replicated there; they do here too (their torch parent is
a Sequential's item `0`).

Nothing in the port consumes these placements: the trainer replicates its
parameters over the data ranks, as JAX's does (`trainer.py:138-153`), and
`mesh_model > 1` raises (ROADMAP.md). JAX uses its rule only in
`__graft_entry__.py`.
"""

from __future__ import annotations

from typing import Dict

from torch import nn

COLUMN_PARENTS = ("fc1", "linear1", "to_q", "to_kv")
ROW_PARENTS = ("fc2", "linear2", "proj")


def param_placements(model: nn.Module, model_size: int) -> Dict[str, str]:
    """{state_dict key: "column" | "row" | "replicate"} of every parameter
    of `model` over a model axis of `model_size` ranks; a weight whose
    split dimension does not divide stays replicated, as in JAX."""

    def rule(name: str, p) -> str:
        parts = name.split(".")
        if model_size > 1 and p.dim() == 2 and len(parts) >= 2 \
                and parts[-1] == "weight":
            out_f, in_f = p.shape
            if parts[-2] in COLUMN_PARENTS and out_f % model_size == 0:
                return "column"
            if parts[-2] in ROW_PARENTS and in_f % model_size == 0:
                return "row"
        return "replicate"

    return {n: rule(n, p) for n, p in model.named_parameters()}
