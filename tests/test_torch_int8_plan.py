"""K8's launch plan (``ops/kernels/int8_linear.py plan``), on the CPU.

The plan is pure Python: which body runs (the wgmma body for bf16
activations and ``out % 16 == 0``, the mma.sync body otherwise), the
wgmma body's token rows a tile (BT) and how its thread-block clusters split
K. The kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py -k int8_linear``); here the plan is held
to the shapes the served models give K8 and to what the C entry points
accept.
"""

import pytest
import torch

from dynamo_tpu_torch.ops.kernels import int8_linear as il

# every 2-D int8_wo product of the served models (in, out)
LLAMA3_8B = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024), "wo": (4096, 4096),
             "gate": (4096, 14336), "up": (4096, 14336), "down": (14336, 4096)}
V2_LITE = {"w_q": (2048, 3072), "w_dkv": (2048, 576), "wo": (2048, 2048), "mlp gate": (2048, 10944),
           "mlp down": (10944, 2048), "shared gate": (2048, 2816), "shared down": (2816, 2048)}
TINYLLAMA = {"wq": (2048, 2048), "wk": (2048, 256), "gate": (2048, 5632), "down": (5632, 2048)}
SERVED_ROWS = (1, 16, 64, 512, 2048)
# DeepSeek-V2-Lite's expert banks [E, C, in] x [E, in, out] at a decode
# step's capacity (3 rows an expert) and a 512-row prefill chunk's (96)
EXPERTS = {"E64 C3 gate": (64, 3, 2048, 1408), "E64 C3 down": (64, 3, 1408, 2048),
           "E64 C96 gate": (64, 96, 2048, 1408), "E64 C96 down": (64, 96, 1408, 2048)}
# the C entry point's tile rows and cluster sizes (w8a16_wgmma_linear)
KERNEL_ROWS = (8, 16, 24, 32, 40, 48, 56, 64, 96, 128)


def _covers_k(p: il.Plan, K: int) -> bool:
    """The splits of ``p`` are K's consecutive ranges of k_per_split rows
    (a multiple of 64), every one of them non-empty."""
    return (p.k_per_split % il.BK == 0 and p.splits * p.k_per_split >= K
            and (p.splits - 1) * p.k_per_split < K)


def _wgmma_accepts(p: il.Plan, K: int, N: int) -> bool:
    """What w8a16_wgmma_linear launches rather than refuses."""
    return (K % 8 == 0 and N % 16 == 0 and p.rows in KERNEL_ROWS and p.splits in il.CLUSTER_SPLITS
            and _covers_k(p, K))


@pytest.mark.parametrize("dtype,N,body", [
    (torch.bfloat16, 4096, "wgmma"), (torch.bfloat16, 576, "wgmma"), (torch.bfloat16, 16, "wgmma"),
    (torch.bfloat16, 1000, "mma"), (torch.bfloat16, 1004, "mma"), (torch.bfloat16, 40, "mma"),
    (torch.float32, 4096, "mma"), (torch.float32, 1000, "mma"),
], ids=["bf16-4096", "bf16-576", "bf16-16", "bf16-1000", "bf16-1004", "bf16-40", "f32-4096", "f32-1000"])
def test_body_from_dtype_and_out_alone(dtype, N, body):
    """The body follows h's dtype and ``out`` and nothing else: the same at
    every row count, depth and expert count."""
    for T in (1, 7, 16, 17, 64, 65, 600, 2048):
        for K, E in ((64, 1), (4096, 1), (14336, 1), (2048, 64)):
            assert il.plan(T, K, N, E, dtype).body == body, (T, K, E)


@pytest.mark.parametrize("T,bt", [(1, 8), (3, 8), (8, 8), (9, 16), (16, 16), (17, 24), (33, 40), (57, 64),
                                  (64, 64), (65, 96), (96, 96), (97, 128), (512, 128), (600, 128),
                                  (2048, 128)])
def test_tile_rows(T, bt):
    """BT: T rounded up to a multiple of 8 up to 64 rows (at most 7 rows of
    padding at decode sizes), 96 or 128 past it; the plan's rows are BT."""
    assert il.tile_rows(T) == bt
    assert il.plan(T, 4096, 4096).rows == bt
    if T <= il.DEEP_ROWS:
        assert bt - T < 8


@pytest.mark.parametrize("tiles", [1, 3, 5, 8, 16, 17, 32, 33, 64, 66, 67, 112, 132, 133, 704])
def test_cluster_splits_cover_k(tiles):
    """Splits are the 1 to 8 blocks of a cluster, cover K exactly in
    multiples of 64 with no empty split, give every split at least
    MIN_SPLIT_K rows, and split only while the blocks are resident at once
    (CLUSTER_BLOCKS); no allowed cluster puts more blocks to work."""
    for K in (64, 200, 256, 576, 1000, 1024, 1408, 2048, 2816, 4096, 5632, 10944, 14336):
        n, per = il.cluster_splits(tiles, K)
        assert n in il.CLUSTER_SPLITS
        assert _covers_k(il.Plan("wgmma", 8, n, per), K), (K, n, per)
        if n > 1:
            assert tiles * n <= il.CLUSTER_BLOCKS[n] <= 132 and per >= il.MIN_SPLIT_K
        for m in il.CLUSTER_SPLITS:
            per_m = -(-(-(-K // il.BK)) // m) * il.BK
            if tiles * m <= il.CLUSTER_BLOCKS[m] and per_m >= il.MIN_SPLIT_K and (m - 1) * per_m < K:
                assert m <= n


@pytest.mark.parametrize("model,name,T", [
    (model, name, T)
    for model, shapes in (("Llama-3-8B", LLAMA3_8B), ("DeepSeek-V2-Lite", V2_LITE), ("TinyLlama-1.1B", TINYLLAMA))
    for name in shapes for T in SERVED_ROWS
])
def test_served_products_take_the_wgmma_body(model, name, T):
    """Every 2-D int8_wo product of the served models, at every served row
    count, runs the wgmma body with a plan its entry point accepts; the
    decode sizes split K until the blocks fill the SMs."""
    K, N = {"Llama-3-8B": LLAMA3_8B, "DeepSeek-V2-Lite": V2_LITE, "TinyLlama-1.1B": TINYLLAMA}[model][name]
    p = il.plan(T, K, N)
    assert p.body == "wgmma" and p.rows == il.tile_rows(T)
    assert _wgmma_accepts(p, K, N)
    cols = 128 if p.rows <= il.DEEP_ROWS else 256
    blocks = -(-N // cols) * -(-T // p.rows) * p.splits
    assert p.splits == 1 or blocks <= il.CLUSTER_BLOCKS[p.splits]


@pytest.mark.parametrize("key", list(EXPERTS))
def test_expert_banks_take_the_wgmma_body(key):
    """The expert banks at C 3 and 96: one launch for every expert on the
    wgmma body (E stays a grid dimension), at 8 and 96 rows a tile."""
    E, C, K, N = EXPERTS[key]
    p = il.plan(C, K, N, E)
    assert p.body == "wgmma" and p.rows == (8 if C == 3 else 96) and p.splits == 1
    assert _wgmma_accepts(p, K, N)


@pytest.mark.parametrize("T,K,N,E", [(16, 4096, 4096, 1), (37, 1000, 1000, 1), (2048, 4096, 14336, 1),
                                     (3, 2048, 1408, 64)])
def test_mma_body_keeps_its_plan(T, K, N, E):
    """f32 activations (and widths that are no multiple of 16) keep the mma
    body's tiling: rows = 16 x row_fragments, K split by k_splits below
    TARGET_BLOCKS blocks, splits covering K."""
    for dtype in (torch.float32, torch.bfloat16):
        p = il.plan(T, K, N, E, dtype)
        if p.body == "wgmma":
            continue
        mf = il.row_fragments(T, -(-N // il.BN), E, dtype)
        blocks = -(-N // il.BN) * -(-T // (16 * mf)) * E
        want = il.k_splits(T, K, blocks) if blocks < il.TARGET_BLOCKS else (1, -(-K // il.BK) * il.BK)
        assert p == il.Plan("mma", 16 * mf, *want)
        assert _covers_k(p, K)
        if dtype == torch.float32:
            assert p.rows <= 64  # f32's hi + lo fragments stop at 64-row tiles


@pytest.mark.parametrize("case", ["dtype", "out", "in", "shapes", "rank", "device", "cpu"])
def test_refusals_stay(case):
    """What K8 refuses it still refuses, before any launch: other dtypes,
    out % 4 != 0, in % 8 != 0, shapes that disagree or have the wrong
    rank, mixed devices, and (the launchers) tensors off the card."""
    h, q, s = torch.zeros(4, 64, dtype=torch.bfloat16), torch.zeros(64, 48, dtype=torch.int8), torch.ones(48)
    if case == "dtype":
        with pytest.raises(ValueError, match="bfloat16 or float32 h"):
            il.check_args(h.half(), q, s, batched=False)
    elif case == "out":
        with pytest.raises(ValueError, match="out % 4"):
            il.check_args(h, q[:, :46], s[:46], batched=False)
    elif case == "in":
        with pytest.raises(ValueError, match="in % 8"):
            il.check_args(h[:, :60], q[:60], s, batched=False)
    elif case == "shapes":
        with pytest.raises(ValueError, match="disagree"):
            il.check_args(h, q[:, :32], s, batched=False)
    elif case == "rank":
        with pytest.raises(ValueError, match="K8 takes"):
            il.check_args(h, q, s, batched=True)
    elif case == "device":
        with pytest.raises(ValueError, match="must be on"):
            il.check_args(h, q.to("meta"), s, batched=False)
    else:
        with pytest.raises(ValueError, match="CUDA tensors"):
            il.int8_linear_kernel(h, q, s)
        with pytest.raises(ValueError, match="CUDA tensors"):
            il.int8_linear_expert_kernel(h[None], q[None], s[None])
