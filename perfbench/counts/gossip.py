"""The least work of one D-SGD mix, whatever transport carries it: the
stacked parameters read once and written once in their dtype, plus the
operands, and 2 nnz(W) P FLOPs."""


def mix_bytes(n_nodes: int, params: int, dtype_bytes: int, operand_bytes: int) -> float:
    return 2.0 * n_nodes * params * dtype_bytes + operand_bytes


def mix_flops(nnz: int, params: int) -> float:
    return 2.0 * nnz * params


def mix_least_s(n_nodes: int, params: int, dtype_bytes: int, operand_bytes: int, nnz: int,
                peaks: dict) -> float:
    """The larger of bytes over HBM bandwidth and FLOPs over the tensor
    peak of the inputs' dtype (TF32 for float32: the fastest rate at which
    any kernel multiplies float32 inputs)."""
    peak = peaks["bf16_flops_per_s"] if dtype_bytes == 2 else peaks["tf32_flops_per_s"]
    return max(mix_bytes(n_nodes, params, dtype_bytes, operand_bytes) / peaks["hbm_bytes_per_s"],
               mix_flops(nnz, params) / peak)
