"""The yardstick's peaks, kernel names and cost functions.

Frozen copies, taken when the benchmark was written, of chip_smoke.py's
data-sheet peaks, `FAMILIES`/`KERNEL_NAMES`, `topk_cost`, `edge_cost`,
`fused_cost` and `_bound_s` (the original stays in chip_smoke.py). Each cost
counts the work its inputs need: every input byte read once, every output
byte written once, and operations over valid pairs or edges only, so a
share reads the same work whatever implements it.
"""

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12        # H100 SXM bf16 dense tensor-core peak

# a substring of the name of the one CUDA kernel each wrapper call launches
KERNEL_NAMES = {"b1_topk": "neighbor_topk_", "b2_edge": "edge_attn_kernel",
                "b3_fused": "fused_stack_kernel"}
FAMILIES = [  # (family, substrings of the kernel name), first match wins
    ("fused_stack (ours)", ("fused_stack_kernel",)),
    ("edge_attn (ours)", ("edge_attn_kernel",)),
    ("neighbor_topk (ours)", ("neighbor_topk_",)),
    ("matmul", ("gemm", "sm90_xmma", "cutlass", "ampere_sgemm", "sgemm", "gemv", "nvjet")),
    ("gather/index", ("index", "gather", "scatter")),
    ("sort", ("sort", "radix")),
    ("reduce", ("reduce",)),
    ("copy/cat", ("copy", "cat", "Cat")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
]
WKVR_FIELD = 5  # the fused stack's packed fields: gd, bd, wq, bq, wkv, wkvr [L, P, 2I], ...


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def topk_cost(B, Q, S, K):
    """Bytes the top-K must move (positions and masks read once, idx and
    valid written once) and its operations (2 sub, 2 mul, 1 add per pair)."""
    return {"bytes": B * Q * 2 * 4 + B * S * 2 * 4 + B * Q + B * S + B * Q * K * (4 + 1),
            "ops": 5 * B * Q * S}


def edge_cost(n_valid, B, Q, K, H, D, Dp, S, size=4):
    """Bytes the edge core must move (per valid edge its idx and its z_r
    row; the mask; each scene's source table once; the queries; the
    outputs; values `size` bytes each, 4 in f32, 2 in bf16) and its
    operations (a multiply-add for the score and one for the aggregate, per
    valid edge, head and dim), at the f32 peak, or in bf16 at the bf16
    tensor cores'."""
    return {"bytes": (n_valid * (4 + Dp * size) + B * Q * K + B * S * D * size
                      + B * Q * H * (D + Dp) * size * 2 + B * Q * H * size),
            "ops": n_valid * 4 * H * (D + Dp), "peak": F32_FLOPS if size == 4 else BF16_FLOPS}


def fused_cost(x_p, tables, weights, num_heads, head_dim):
    """Bytes the fused stack must move (x, both sites' source tokens, idx,
    feats and valid, both sites' packed weights, each read once; the output
    written once) and its operations: per valid edge and layer 2 H (D + P)
    multiply-adds for the score and the aggregate; per valid edge once per
    call the rel-PE expansion at 8 operations per column; per query row and
    layer the dense products' multiply-adds (to_q, the two folds, to_g,
    to_s, to_out, the FFN). In bf16 the bytes are at the bf16 sizes and the
    operations at the bf16 peak."""
    B, N, D = x_p.shape
    H, I = num_heads, num_heads * head_dim
    L, P = weights[0][0].shape[0], weights[0][WKVR_FIELD].shape[1]
    es = x_p.element_size()
    dense = D * I + 2 * I * (D + P) + (I + D) * I + 2 * D * I + 8 * D * D
    nbytes = 2 * B * N * D * es + es * sum(t.numel() for w in weights for t in w)
    ops = 0
    for x_src, idx, feats, valid in tables:
        nbytes += es * x_src.numel() + 4 * (idx.numel() + feats.numel()) + valid.numel()
        n_valid = int(valid.sum())
        ops += L * n_valid * 4 * H * (D + P) + n_valid * 8 * P + 2 * L * B * N * dense
    return {"bytes": nbytes, "ops": ops, "peak": F32_FLOPS if es == 4 else BF16_FLOPS}


def bound_s(cost) -> float:
    """The least time the chip could take: the larger of bytes over HBM
    bandwidth and operations over the cost's own peak (f32 unless named)."""
    return max(cost["bytes"] / HBM_BYTES_PER_S, cost["ops"] / cost.get("peak", F32_FLOPS))


def peak_flops(dtype_name: str) -> float:
    """The whole step's peak for MFU: the configuration's compute dtype's."""
    return {"float32": F32_FLOPS, "bfloat16": BF16_FLOPS}[dtype_name]
