"""The layouts around the port's Hopper attention kernels, on the CPU.

K10 (``csrc/mha_int8.cu``) packs P, the int8 softmax of its scores, straight
from the score accumulator's registers into the A operand of its P V wgmma,
so the k slots of each 32-key group hold the keys in a permuted order, and
its quantize pass writes V^T, per (batch, column) the keys innermost,
zero-padded to the key bucket and in that order (``int8_kernels.key_slots``,
``vt_slot_layout``). The bucket (``mha_int8_keys``) is a multiple of 32, the
P V k step, split into the widths N that int8 wgmma takes. None of this runs
on the CPU's plain path, so these tests hold the layouts themselves: the slot
order derived here from the two register fragments as the PTX ISA lays them
out, P in slot order against that V^T giving the twin's exact int32 P V, and
the buckets for every key count the kernel takes. The kernel's own V^T is
held against ``vt_slot_layout`` bit for bit on the card
(``tests/test_torch_kernels_gpu.py``).
"""

import numpy as np
import pytest
import torch

from text_to_sound_synthesis_torch.ops import attention as attn
from text_to_sound_synthesis_torch.ops import int8_kernels as ik
from text_to_sound_synthesis_torch.ops.quant import _quantize_rows

# key counts at and beside the buckets' edges, the cross (77) and the self
# attention's (265) counts, and the most the kernel takes (272)
KEYS = (1, 31, 32, 33, 77, 80, 265, 272)


def _fragment_slot_keys(padded: int) -> torch.Tensor:
    """The key whose score the kernel packs into each k slot, from the
    register layouts alone. The S accumulator (wgmma m64nN, per warp
    mma.sync.m16n8's C layout) gives lane (g, t) = (lane / 4, lane % 4)
    element e of 8-key tile j at key 8 j + 2 t + e % 2; the A fragment of
    the s8 wgmma (per warp mma.sync.m16n8k32's A layout) gives register r,
    byte b of k step kt the slot 32 kt + 16 (r / 2) + 4 t + b. The kernel
    packs (tile, element) (4 kt, 0), (4 kt, 1), (4 kt + 1, 0), (4 kt + 1, 1)
    into register 0; elements 2 and 3 (row g + 8) into register 1; tiles
    4 kt + 2 and 4 kt + 3 likewise into registers 2 and 3."""
    keys = torch.full((padded,), -1, dtype=torch.long)
    for kt in range(padded // 32):
        for r in range(4):
            for b in range(4):
                tile = 4 * kt + 2 * (r // 2) + b // 2
                element = 2 * (r % 2) + b % 2
                for t in range(4):
                    slot = 32 * kt + 16 * (r // 2) + 4 * t + b
                    key = 8 * tile + 2 * t + element % 2
                    assert keys[slot] in (-1, key)
                    keys[slot] = key
    return keys


@pytest.mark.parametrize("padded", [32, 96, 160, 288])
def test_key_slots_are_the_register_fragments_order(padded):
    """``key_slots`` is the order the score registers pack in, and a
    permutation within each 32-key group."""
    slots = ik.key_slots(padded)
    assert torch.equal(slots, _fragment_slot_keys(padded))
    assert torch.equal(slots // 32, torch.arange(padded) // 32)
    assert torch.equal(slots.sort().values, torch.arange(padded))


def test_key_buckets_cover_every_key_count():
    """For each of 1..272 keys: a multiple of 32 that covers them, the
    smallest of the kernel's buckets that does, split into widths that int8
    wgmma takes (N = 8, 16, 24 or a multiple of 16 from 32 to 256)."""
    legal = {8, 16, 24} | set(range(32, 257, 16))
    pads = []
    for keys in range(1, 273):
        padded, parts = ik.mha_int8_keys(keys)
        assert padded % 32 == 0 and keys <= padded < keys + 128
        assert sum(parts) == padded and all(n in legal for n in parts)
        assert all(padded <= p or keys > p for p in pads)   # the smallest bucket that covers
        pads = sorted(set(pads) | {padded})
    assert pads == [32, 96, 160, 288]
    assert ik.mha_int8_keys(265) == (288, (144, 144))
    assert ik.mha_int8_keys(77) == (96, (96,))
    for keys in (0, 273):
        with pytest.raises(ValueError):
            ik.mha_int8_keys(keys)


@pytest.mark.parametrize("keys", KEYS)
def test_vt_slot_layout_transposes_permutes_and_pads(keys):
    """V^T of each batch element: row d holds column d of V, key
    ``key_slots[slot]`` at each slot, zeros past the keys."""
    rng = np.random.default_rng(keys)
    B, D = 2, 96
    vq = torch.from_numpy(rng.integers(-127, 128, (B * keys, D)).astype(np.int8))
    vt = ik.vt_slot_layout(vq, B)
    padded, _ = ik.mha_int8_keys(keys)
    assert vt.shape == (B, D, padded) and vt.dtype == torch.int8 and vt.is_contiguous()
    slots = ik.key_slots(padded)
    for b in range(B):
        for slot in range(padded):
            key = int(slots[slot])
            want = vq[b * keys + key] if key < keys else torch.zeros(D, dtype=torch.int8)
            assert torch.equal(vt[b, :, slot], want)


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("keys", KEYS)
def test_p_in_slot_order_against_vt_is_the_twins_int32_pv(keys, hd):
    """P quantized as the twin quantizes it (per (head, query) row of the
    softmax), laid out in slot order and zero-padded, times V^T from
    ``vt_slot_layout``: the twin's int32 P V, exactly, for every head."""
    rng = np.random.default_rng(1000 * hd + keys)
    B, H, Lq = 2, 128 // hd, 40
    D = H * hd
    s = torch.from_numpy(rng.standard_normal((B, H, Lq, keys)).astype(np.float32)) * 3
    if keys > 3:
        s[..., keys - 2:] = float("-inf")                                # masked keys: p = 0
    p = torch.softmax(s, dim=-1)
    pq, _ = _quantize_rows(p)                                            # (B, H, Lq, keys)
    v = torch.from_numpy(rng.standard_normal((B * keys, D)).astype(np.float32))
    vq, _ = _quantize_rows(v.reshape(B, keys, D).transpose(1, 2))        # per column
    vq = vq.transpose(1, 2).reshape(B * keys, D)
    vh = vq.reshape(B, keys, H, hd).transpose(1, 2).long()               # (B, H, keys, hd)
    want = pq.long() @ vh                                                # the twin's int32 P V

    padded, _ = ik.mha_int8_keys(keys)
    slots = ik.key_slots(padded)
    p_pad = torch.zeros((B, H, Lq, padded), dtype=torch.long)
    p_pad[..., :keys] = pq.long()
    p_slot = p_pad[..., slots]                                           # k slot order
    vt = ik.vt_slot_layout(vq, B).long().reshape(B, H, hd, padded)
    got = p_slot @ vt.transpose(-1, -2)
    assert torch.equal(got, want)
    assert int(want.abs().max()) < 2 ** 31


@pytest.mark.parametrize("keys", [32, 77])
def test_mha_pair_wrapper_runs_its_twin_on_the_cpu(keys):
    """``attention.mha_pair`` on CPU tensors: ``mha_pair_reference``, bit for
    bit, and no launch counted; an odd number of heads is refused."""
    g = torch.Generator().manual_seed(keys)
    B, L, D, H = 2, 40, 256, 4
    q = torch.randn((B * L, D), generator=g).bfloat16()
    k, v = (torch.randn((B * keys, D), generator=g).bfloat16() for _ in range(2))
    launches = attn.mha_pair.launches
    got = attn.mha_pair(q, k, v, batch=B, n_head=H, kv_valid=keys - 3)
    want = attn.mha_pair_reference(q, k, v, batch=B, n_head=H, kv_valid=keys - 3)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert attn.mha_pair.launches == launches
    with pytest.raises(ValueError):
        attn.mha_pair(q[:, :192], k[:, :192], v[:, :192], batch=B, n_head=3, kv_valid=keys)


def test_bench_mha_refuses_unknown_names_and_needs_a_card():
    """The MHA A/B tool: unknown names exit 2, and without a card 1."""
    from text_to_sound_synthesis_torch.tools import bench_mha

    assert bench_mha.main(["nope"]) == 2
    assert bench_mha.main(["pair"]) == (0 if torch.cuda.is_available() else 1)
