from alphazero_torch.models.network import (
    AlphaZeroNet,
    SEResBlock,
    SqueezeExcite,
    build_network,
    count_params,
    policy_value_apply,
    wl_to_value,
)

__all__ = [
    "AlphaZeroNet", "SEResBlock", "SqueezeExcite", "build_network",
    "count_params", "policy_value_apply", "wl_to_value",
]
