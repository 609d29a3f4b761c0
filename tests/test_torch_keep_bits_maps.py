"""The fragment maps by which the bf16 flash kernels regenerate the dropout
keep bits (`ops/csrc/keep_bits.cuh`), modelled in numpy: map (a), the
forward's S tile (rows q, columns keys), and map (b), the main backward's
S^T tile (rows keys, columns q, in passes of NQ q columns), at the tile
shapes the CUDA sources define. Each map visits every in-range element of
a tile once; (b) is (a) transposed; and a dump assembled as
`ops/csrc/keep_bits_dump.cu` assembles it -- each accumulator element's bit
drawn at the (q, key) its map gives, from the thread's first element's hash
input plus a constant, and written where the wgmma accumulator layout puts
that element (which the kernel's `stmatrix` does) -- equals the port's
plain `keep_bits` and the JAX package's `_keep_bits`. A map with its rows
and columns swapped, or with 2t and g exchanged, moves bits. These tests
hold the model; `chip_smoke.py`'s `bits_check` holds the CUDA kernels on
the card."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.ops import attention as jatt
from multimodal_sequencing_tpu_torch.ops import _build
from multimodal_sequencing_tpu_torch.ops import attention as tatt
from multimodal_sequencing_tpu_torch.tools import sass_diff

torch.set_num_threads(1)

CSRC = Path(tatt.__file__).resolve().parent / "csrc"
KEEP_MUL = np.uint32(0x9E3779B9)


def _const(name: str, source: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} in {source}"
    return int(m.group(1))


# The instances' tile shapes, from the sources: the forward's S tile is
# BLOCK_M x BLOCK_N and the main backward's S^T tile BLOCK x BLOCK in
# passes of NQ = BLOCK / HALVES q columns, at every head width.
BLOCK_M = _const("BLOCK_M", "flash_fwd.cu")
BLOCK_N = _const("BLOCK_N", "flash_fwd.cu")
BLOCK = _const("BLOCK", "flash_bwd.cu")
NQ = BLOCK // _const("HALVES", "flash_bwd.cu")
TILE = _const("TILE", "keep_bits_dump.cu")


def test_instances_have_the_tiles_the_model_takes():
    # every instance tiles S by 64 in both dimensions, and the dump replays
    # the backward's pass width
    assert BLOCK_M == BLOCK_N == BLOCK == TILE == 64
    assert NQ == _const("MAIN_NQ", "keep_bits.cuh") == 32


# ----- the model -------------------------------------------------------------


def acc_layout(n_cols):
    """The wgmma m64nNk16 f32 accumulator layout (PTX ISA): register i of
    lane L of warp w holds row 16 w + L / 4 + 8 ((i % 4) / 2) and column
    8 (i / 4) + 2 (L % 4) + i % 2 of the 64 x n_cols tile. Arrays over
    (warp, lane, register)."""
    w, lane, i = np.meshgrid(np.arange(4), np.arange(32), np.arange(n_cols // 2),
                             indexing="ij")
    return (16 * w + lane // 4 + 8 * ((i % 4) // 2),
            8 * (i // 4) + 2 * (lane % 4) + i % 2)


def _threads(n_cols):
    """(warp, g, t, j, e) of every (warp, lane, register i = 4 j + e)."""
    w, lane, i = np.meshgrid(np.arange(4), np.arange(32), np.arange(n_cols // 2),
                             indexing="ij")
    return w, lane // 4, lane % 4, i // 4, i % 4


def map_a(q0, k0, w, g, t, j, e):
    """keep_bits.cuh::fwd_s_frag(q0 + frag_row0(w, g), k0, t, j, e):
    (q, key)."""
    return q0 + 16 * w + g + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1)


def map_b(k0, q0, w, g, t, hf, jj, e):
    """keep_bits.cuh::bwd_st_frag(bwd_st_key0(k0, w, g), q0,
    bwd_st_col<NQ>(t, hf, jj, e), e): (q, key)."""
    return q0 + hf * NQ + 8 * jj + 2 * t + (e & 1), k0 + 16 * w + g + 8 * (e >> 1)


# the same maps with their rows and columns swapped, or with 2t and g
# exchanged
WRONG_MAPS = {
    "swapped": (lambda q0, k0, w, g, t, j, e: (q0 + 8 * j + 2 * t + (e & 1),
                                               k0 + 16 * w + g + 8 * (e >> 1)),
                lambda k0, q0, w, g, t, hf, jj, e: (
                    q0 + 16 * w + g + 8 * (e >> 1),
                    k0 + hf * NQ + 8 * jj + 2 * t + (e & 1))),
    "g_2t": (lambda q0, k0, w, g, t, j, e: (q0 + 16 * w + 2 * t + 8 * (e >> 1),
                                            k0 + 8 * j + g + (e & 1)),
             lambda k0, q0, w, g, t, hf, jj, e: (
                 q0 + hf * NQ + 8 * jj + g + (e & 1),
                 k0 + 16 * w + 2 * t + 8 * (e >> 1))),
}


def tile_elements(order, q0, k0, maps=(map_a, map_b)):
    """One tile's elements in a kernel's visit: ((q, key) the map draws
    the bit at, (q, key) the accumulator element lies at), flat arrays."""
    if order == "fwd":
        w, g, t, j, e = _threads(BLOCK_N)
        drawn = maps[0](q0, k0, w, g, t, j, e)
        row, col = acc_layout(BLOCK_N)
        held = (q0 + row, k0 + col)
    else:  # HALVES passes of a 64 x NQ product: rows keys, columns q
        w, g, t, jj, e = _threads(NQ)
        drawn, held = ([], []), ([], [])
        row, col = acc_layout(NQ)
        for hf in range(BLOCK // NQ):
            q, key = maps[1](k0, q0, w, g, t, hf, jj, e)
            drawn[0].append(q), drawn[1].append(key)
            held[0].append(q0 + hf * NQ + col), held[1].append(k0 + row)
        drawn = tuple(np.stack(x) for x in drawn)
        held = tuple(np.stack(x) for x in held)
    return tuple(x.ravel() for x in drawn), tuple(x.ravel() for x in held)


def _mix32(x):
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def model_dump(order, seed, b, h, s, p, maps=(map_a, map_b), index=None):
    """(B, H, S, S) int8 dump as keep_bits_dump.cu writes it (-1 where no
    element was written): the forward's blocks (a q tile over the key
    tiles) or the main backward's items (a key tile over the q tiles from
    its own); each bit drawn at its map's (q, key) from the hash input of
    the thread's first element plus the element's offset times the
    multiplier, kept where (mix32 & 0x7FFFFFFF) - thresh is negative, and
    written where the accumulator element lies."""
    thresh = np.uint32(tatt.keep_threshold(p))
    seeds = tatt._seed_for_bh(seed, tatt.global_bh(b, h, index)).numpy()
    seeds = seeds.astype(np.uint32)[:, None]
    n_t = -(-s // TILE)
    out = np.full((b * h, s, s), -1, np.int8)
    su = np.uint32(s)
    for blk in range(n_t):
        for it in range(n_t):
            if order == "fwd":
                q0, k0 = blk * TILE, it * TILE
            else:
                k0, q0 = blk * TILE, (blk + it) % n_t * TILE
            (q, key), (hq, hk) = tile_elements(order, q0, k0, maps)
            # each element's thread's first element (j = e = 0; hf = 0)
            (fq, fk), _ = tile_elements(order, q0, k0, (
                lambda q0, k0, w, g, t, j, e: maps[0](q0, k0, w, g, t, 0, 0),
                lambda k0, q0, w, g, t, hf, jj, e: maps[1](k0, q0, w, g, t,
                                                           0, 0, 0)))
            in0 = ((fq.astype(np.uint32) * su + fk.astype(np.uint32))
                   * KEEP_MUL + seeds)
            off = ((q - fq) * s + key - fk).astype(np.uint32)
            sign = ((_mix32(in0 + off * KEEP_MUL) & np.uint32(0x7FFFFFFF))
                    - thresh)
            bits = (sign >> np.uint32(31)).astype(np.int8)
            inside = (hq < s) & (hk < s)
            out[:, hq[inside], hk[inside]] = bits[:, inside]
    return out.reshape(b, h, s, s)


# ----- the maps ----------------------------------------------------------------


@pytest.mark.parametrize("order", ["fwd", "dkv"])
@pytest.mark.parametrize("s,origin", [(64, (0, 0)), (70, (64, 0)),
                                      (70, (64, 64)), (320, (256, 128))])
def test_map_visits_each_in_range_element_once(order, s, origin):
    q0, k0 = origin
    (q, key), _ = tile_elements(order, q0, k0)
    # the whole 64 x 64 tile once, so its in-range part once
    flat = (q - q0) * TILE + (key - k0)
    assert np.array_equal(np.sort(flat), np.arange(TILE * TILE))
    inside = (q < s) & (key < s)
    assert inside.sum() == (min(s, q0 + TILE) - q0) * (min(s, k0 + TILE) - k0)
    assert len(set(zip(q[inside], key[inside]))) == inside.sum()


def test_map_b_is_map_a_transposed():
    w, g, t, jj, e = _threads(NQ)
    k0, q0 = 128, 64
    for hf in range(BLOCK // NQ):
        q, key = map_b(k0, q0, w, g, t, hf, jj, e)
        row, col = map_a(k0, q0 + hf * NQ, w, g, t, jj, e)
        assert np.array_equal(key, row) and np.array_equal(q, col)
    # and the S^T tile's elements, transposed, are the S tile's
    (qa, ka), _ = tile_elements("fwd", 0, 0)
    (qb, kb), _ = tile_elements("dkv", 0, 0)
    assert set(zip(qa, ka)) == set(zip(qb, kb))


@pytest.mark.parametrize("order", ["fwd", "dkv"])
@pytest.mark.parametrize("s", [16, 70, 256, 320])
def test_model_dump_is_the_plain_bits(order, s):
    seed, b, h, p = 1234, 1, 2, 0.1
    got = model_dump(order, seed, b, h, s, p)
    assert (got >= 0).all()
    plain = tatt.keep_bits(seed, b, h, s, p).numpy()
    np.testing.assert_array_equal(got.astype(bool), plain)
    rows = jnp.arange(s, dtype=jnp.int32)
    for bh in range(b * h):
        want = np.asarray(jatt._keep_bits(
            jatt._seed_for_bh(jnp.int32(seed), jnp.int32(bh)), rows, rows, s,
            tatt.keep_threshold(p)))
        np.testing.assert_array_equal(got.reshape(b * h, s, s)[bh], want)


@pytest.mark.parametrize("order", ["fwd", "dkv"])
def test_model_dump_at_a_global_head_index(order):
    # a tensor-parallel rank's heads draw the whole batch's bits of theirs
    got = model_dump(order, -7, 2, 2, 99, 0.25, index=(1, 3, 6))
    want = tatt.keep_bits(-7, 3, 6, 99, 0.25)[1:, 3:5].numpy()
    np.testing.assert_array_equal(got.astype(bool), want)


@pytest.mark.parametrize("order", ["fwd", "dkv"])
@pytest.mark.parametrize("wrong", sorted(WRONG_MAPS))
def test_a_wrong_map_moves_bits(order, wrong):
    maps = WRONG_MAPS[wrong]
    maps = (maps[0], map_b) if order == "fwd" else (map_a, maps[1])
    got = model_dump(order, 1234, 1, 2, 70, 0.1, maps)
    assert not np.array_equal(got, tatt.keep_bits(1234, 1, 2, 70, 0.1).numpy())
    if wrong == "g_2t":  # not even a permutation of the tile
        (q, key), _ = tile_elements(order, 0, 0, maps)
        assert len(set(zip(q, key))) < TILE * TILE


# ----- the tool that holds the kernels' code to the parent's -----------------


def test_sass_diff_reads_ptxas_lines_without_the_namespace_hash():
    log = ("ptxas info    : Compiling entry function "
           "'_ZN45_GLOBAL__N__3e7670d3_12_flash_bwd_cu_3c15cd2821k' for 'sm_90a'\n"
           "    72 bytes stack frame, 64 bytes spill stores, 96 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 1 barriers\n"
           "ptxas info    : Function properties for other\n")
    want = {"_ZN45_GLOBAL__N___12_flash_bwd_cu_3c15cd2821k": [
        "72 bytes stack frame, 64 bytes spill stores, 96 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers"]}
    assert sass_diff._ptxas(log) == want
    assert sass_diff._ptxas(log.replace("3e7670d3", "df789844")) == want


def test_sass_diff_needs_nvcc(monkeypatch, capsys):
    def missing():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "_nvcc", missing)
    assert sass_diff.main(["--root", "."]) == 1
    assert "nvcc not found" in capsys.readouterr().err
