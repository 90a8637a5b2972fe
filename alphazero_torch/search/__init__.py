from alphazero_torch.search.mcts import (
    SearchSpec,
    Tree,
    advance_root,
    init_tree,
    make_net_evaluator,
    root_action_probs,
    root_child_visits,
    root_value,
    search,
)

__all__ = [
    "SearchSpec", "Tree", "advance_root", "init_tree", "make_net_evaluator",
    "root_action_probs", "root_child_visits", "root_value", "search",
]
