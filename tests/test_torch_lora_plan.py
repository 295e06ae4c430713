"""The grouped LoRA kernel's plan and its host side, on the CPU.

``ops/cuda/lora.py`` ``lora_plan`` splits and tiles a call from shapes and
the card's SM count only (``csrc/lora.cu`` reads it): at every shape of
``chip_smoke.py``'s LoRA cases (llama3-8b's and llama3-70b's projections,
decode to prefill rows) the shrink's row tiles cover every row, its
split-K slices partition the chunks of K exactly (interleaved: split s
takes chunks s, s + P, ...), at least two chunks a slice, and the expand's column tiles cover
every column of every target once and its row blocks every row. The
scratch a call needs, the groups a resident tree makes (one call a group
and layer) and the refusals of factors the kernel does not take are
checked here too; the kernel itself only on the card
(``tests/test_torch_cuda_kernels.py``).
"""

import pytest
import torch

from generativeaiexamples_tpu_torch.ops import lora as lora_ops
from generativeaiexamples_tpu_torch.ops.cuda import lora as cl

# (K, (O of each target of the group)): llama3-8b's and llama3-70b's groups
GROUPS = {
    "8b_qkv": (4096, (4096, 1024, 1024)), "8b_wo": (4096, (4096,)),
    "8b_gate_up": (4096, (14336, 14336)), "8b_down": (14336, (4096,)),
    "70b_qkv": (8192, (8192, 1024, 1024)), "70b_wo": (8192, (8192,)),
    "70b_gate_up": (8192, (28672, 28672)), "70b_down": (28672, (8192,)),
}
# rows: a narrow decode step of 8 slots, the W = 9 rung, the 70b smoke's
# mixed width, the grouped prefill of 8 chunks of 512, a 12-slot ladder
ROWS = (8, 72, 584, 4096, 12, 1, 130)
N_SM = 132
SMEM = 227 * 1024           # a block's shared memory on the H100


@pytest.mark.parametrize("rank", [16, 64])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_plan_covers_every_row_column_and_chunk(group, rows, rank):
    K, O = GROUPS[group]
    plan = cl.lora_plan(rows, K, O, N_SM, 4, rank)
    # the shrink: row tiles of 16 G rows over every row, K in P slices
    assert plan.G in (1, 2, 4) and plan.P >= 1
    assert (plan.tiles - 1) * 16 * plan.G < rows <= plan.tiles * 16 * plan.G
    assert plan.P <= cl.MAX_SPLITS
    chunks = -(-K // cl.CHUNK)
    splits = cl.split_chunks(K, plan)
    assert sorted(c for split in splits for c in split) == list(range(chunks))
    assert all(split == sorted(split) and len(split) >= 2
               for split in splits)
    # the expand: every column of every target, every row
    assert plan.col_tiles == sum(-(-o // cl.TILE_COLS) for o in O)
    tile_rows = plan.RT * cl.TILE_ROWS
    assert (plan.row_blocks - 1) * tile_rows < rows \
        <= plan.row_blocks * tile_rows
    assert 1 <= plan.RT <= 8
    # grid and shared memory within the card's: no cluster is used; a
    # decode batch stages all three adapter slots where the ring holds them
    assert plan.P <= 65535 and plan.row_blocks <= 65535
    assert cl.shrink_smem(plan.G, plan.SB, len(O), rank) <= cl.SHRINK_SMEM
    assert plan.SB * cl.TILE_COLS * 128 + 1024 + 1024 <= SMEM
    if rows > 4 * cl.TILE_ROWS:
        assert plan.SB == 1
    elif rank == 16:
        assert plan.SB == 3


def test_plan_spreads_decode_and_stages_by_batch():
    """A decode batch fills the card with K splits and stages every
    adapter slot at once; a prefill batch takes four row groups a CTA,
    stages one slot, and covers several row tiles a CTA."""
    d = cl.lora_plan(8, 4096, (14336, 14336), N_SM, 4)
    assert (d.G, d.tiles, d.SB, d.RT) == (1, 1, 3, 1)
    assert d.P == 16
    assert cl.lora_plan(8, 4096, (4096,), N_SM, 1).SB == 1    # a global tree
    p = cl.lora_plan(4096, 4096, (14336, 14336), N_SM, 4)
    assert (p.G, p.tiles, p.SB) == (4, 64, 1)
    assert p.tiles * p.P >= 2 * N_SM and p.RT == 8
    assert cl.lora_plan(4096, 14336, (4096,), N_SM, 4).P >= 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_scratch_holds_z_and_the_partials(dtype):
    esz = 2 if dtype == torch.bfloat16 else 4
    for nt, r, T, P in ((3, 16, 8, 16), (1, 8, 4096, 1), (2, 64, 72, 32),
                        (1, 40, 584, 9)):
        zw = nt * (-(-r // 16) * 16)
        z = -(-(T * zw * esz) // 256) * 256
        assert z >= T * zw * esz and z % 256 == 0
        assert cl.scratch_bytes(dtype, nt, r, T, P) == \
            z + (P * T * zw * 4 if P > 1 else 0)


def _tree(L, N, rank, targets, dims):
    g = torch.Generator().manual_seed(0)
    return {t: {"a": torch.randn((L, N, rank, dims[t][0]), generator=g),
                "b": torch.randn((L, N, dims[t][1], rank), generator=g)}
            for t in targets}


DIMS = {"wq": (64, 64), "wk": (64, 32), "wv": (64, 32), "wo": (64, 64),
        "w_gate": (64, 128), "w_up": (64, 128), "w_down": (128, 64)}


def test_prepare_makes_one_group_an_input():
    """Seven targets make 4 calls a layer, the reference's four 2; targets
    of another rank take a call of their own; each group holds layer i's
    views of the stacks, in the block's order."""
    seven = lora_ops.prepare(_tree(2, 3, 8, list(DIMS), DIMS), 2)
    assert lora_ops.group_count(seven) == 4 and len(seven) == 2
    assert [[g.targets for g in gs] for gs in seven[1].values()] == [
        [("wq", "wk", "wv")], [("wo",)], [("w_gate", "w_up")],
        [("w_down",)]]
    four = _tree(2, 3, 8, ["wq", "wk", "wv", "wo"], DIMS)
    layers = lora_ops.prepare(four, 2)
    assert lora_ops.group_count(layers) == 2
    g = layers[1]["wq"][0]
    assert g.kernel is None and g.a[1].data_ptr() == four["wk"]["a"][1] \
        .data_ptr()
    mixed = dict(four, wv=_tree(2, 3, 16, ["wv"], DIMS)["wv"])
    assert [g.targets for g in lora_ops.prepare(mixed, 2)[0]["wq"]] == [
        ("wq", "wk"), ("wv",)]


def test_resident_group_refuses_what_the_kernel_cannot_take():
    """Factors are checked once, when they become resident: CPU tensors,
    more than three targets, ranks that differ, a rank or depth the
    kernel does not take all raise ValueError."""
    t = _tree(1, 2, 8, ["wq", "wk", "wv", "wo"], DIMS)
    a = [t[n]["a"][0] for n in t]
    b = [t[n]["b"][0] for n in t]
    with pytest.raises(ValueError, match="CUDA"):
        cl.ResidentGroup(a[:3], b[:3])
    with pytest.raises(ValueError, match="1 to 3"):
        cl.ResidentGroup(a, b)
    with pytest.raises(ValueError, match="agree"):
        cl.ResidentGroup([a[0], a[1][:, :4].contiguous()],
                         [b[0], b[1][..., :4].contiguous()])
    with pytest.raises(ValueError, match="limits"):
        cl.ResidentGroup([a[0].bfloat16()[:, :4]],
                         [b[0].bfloat16()[..., :4]])
