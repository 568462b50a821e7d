"""The mixture-of-experts FFN's parameter tree (counterpart of the
reference's ``repro/models/moe.py``, its spec only; the dense and capacity
routings wait for ROADMAP A9c)."""
from __future__ import annotations

from .spec import ParamSpec


def moe_spec(cfg) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.param_dtype
    spec = {
        "router": ParamSpec((d, e), (None, None), dt),
        "wg": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp"), dt),
        "wu": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp"), dt),
        "wd": ParamSpec((e, f, d), ("experts", "expert_mlp", "embed"), dt),
    }
    if cfg.shared_expert:
        spec["shared"] = {
            "wg": ParamSpec((d, f), ("embed", "mlp"), dt),
            "wu": ParamSpec((d, f), ("embed", "mlp"), dt),
            "wd": ParamSpec((f, d), ("mlp", "embed"), dt),
        }
    return spec
