"""Training FLOPs of the simulator's linear-model step (the benchmark's
count)."""


def params_per_node(dim: int, num_classes: int) -> int:
    """P: w (dim, classes) and b (classes,)."""
    return dim * num_classes + num_classes


def train_flops_per_step(n_nodes: int, batch: int, dim: int, num_classes: int) -> float:
    """4 P B n: the forward product and the weights' gradient over every
    node's minibatch (the inputs need no gradient; evaluation and mixing
    excluded)."""
    return 4.0 * params_per_node(dim, num_classes) * batch * n_nodes
