"""Head widths the card's attention kernels are not built for, and the bf16
backward's schedule, on the CPU.

The kernels take head widths 16, 32, 64 and 128; a call at another width up
to 128 runs at the next of them on zero-padded tensors with the true
width's scale (`ops/attention.py::with_kernel_width`). Here that function
wraps the plain versions and is held against the JAX package: forward
against `attention_reference` (no dropout) and the Pallas flash kernel in
interpret mode (hash bits, p = 0.1), backward against JAX's gradients. An
encoder read from an HF `config.json` with 128-wide heads runs against the
JAX `TextEncoder` on the same weights. And a host-side model of the main
kernel's persistent schedule (`bwd_turn`, `bwd_groups`, and the lanes of
`csrc/flash_bwd.cu`, each a consumer that leaves its dq partials in two
slots and a writer that adds them in turn, lagging it) shows that every
wait for a dq turn ends, under any interleaving of the lanes, and that
each q tile takes its adds in one fixed order."""

import argparse
import dataclasses
import json
import math
import random
import re
from collections import defaultdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sequencing_tpu.models import config as jcfg
from multimodal_sequencing_tpu.models.encoder import TextEncoder as JTextEncoder
from multimodal_sequencing_tpu.models.sequencer import (
    SequencingModel as JSequencingModel)
from multimodal_sequencing_tpu.ops import attention as jatt
from multimodal_sequencing_tpu.train import cli as jcli
from multimodal_sequencing_tpu_torch.models import config as tcfg
from multimodal_sequencing_tpu_torch.models import encoder as tenc
from multimodal_sequencing_tpu_torch.models.convert import params_from_jax
from multimodal_sequencing_tpu_torch.ops import attention as tatt
from multimodal_sequencing_tpu_torch.train import cli as tcli

torch.set_num_threads(1)

REL = 1e-5  # of the largest |value|: f32 on both sides, sums in another order
WIDTHS = [8, 24, 48, 80, 96, 128]
SEED = 1234


def _inputs(d, b=2, h=2, s=40, seed=0):
    """q, k, v, dO of std 0.5 (f32 numpy) and a (B, S) key mask with a
    padded tail in every row (no row fully masked: there the plain
    backward's zero gradient and autodiff's differ by design)."""
    rng = np.random.RandomState(seed + d)
    q, k, v, do = (rng.randn(b, h, s, d).astype(np.float32) * 0.5
                   for _ in range(4))
    mask = np.ones((b, s), np.int32)
    mask[:, int(0.75 * s):] = 0
    mask[-1, int(0.5 * s):] = 0
    return q, k, v, do, mask


def _jax_attention(mask, p):
    """(q, k, v) -> o of the JAX package: the XLA reference without
    dropout, the Pallas kernel (interpret mode, hash bits) with it."""
    m = jnp.asarray(mask)
    if p == 0.0:
        return lambda q, k, v: jatt.attention_reference(q, k, v, mask=m)
    seed = jnp.int32(SEED)
    return lambda q, k, v: jatt._flash_attention_ad(q, k, v, m, seed, p,
                                                    True, False)


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=REL * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("d", WIDTHS)
def test_padded_plain_forward_matches_jax(d, p):
    q, k, v, _, mask = _inputs(d)
    o, lse = tatt.with_kernel_width(
        tatt.attention_reference_lse,
        *(torch.from_numpy(x) for x in (q, k, v, mask)), p, SEED)
    assert o.shape == q.shape and lse.shape == (4, 40)
    want = _jax_attention(mask, p)(*(jnp.asarray(x) for x in (q, k, v)))
    _close(o.numpy(), want, f"o at width {d}")
    # the scale is the true width's: the unpadded plain version agrees
    o_plain, lse_plain = tatt.attention_reference_lse(
        *(torch.from_numpy(x) for x in (q, k, v, mask)), p, SEED)
    torch.testing.assert_close(lse, lse_plain, rtol=0, atol=1e-6)
    torch.testing.assert_close(o, o_plain, rtol=0, atol=1e-6)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("d", WIDTHS)
def test_padded_plain_backward_matches_jax_gradients(d, p):
    q, k, v, do, mask = _inputs(d)
    qt, kt, vt, dot, mt = (torch.from_numpy(x) for x in (q, k, v, do, mask))
    o, lse = tatt.with_kernel_width(tatt.attention_reference_lse, qt, kt, vt,
                                    mt, p, SEED)
    got = tatt.with_kernel_width(tatt.attention_bwd_reference, qt, kt, vt,
                                 mt, o, lse, dot, p, SEED)
    _, vjp = jax.vjp(_jax_attention(mask, p),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == q.shape, name
        _close(g.numpy(), w, f"{name} at width {d}")


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_kernel_widths_pass_through_uncopied(d):
    q, k, v, do, mask = (torch.from_numpy(x) for x in _inputs(d))
    seen = {}

    def fn(q, k, v, mask, do, *, scale):
        seen.update(ptrs=[x.data_ptr() for x in (q, k, v, mask, do)],
                    scale=scale)
        return q, k.sum()

    out = tatt.with_kernel_width(fn, q, k, v, mask, do)
    assert seen["ptrs"] == [x.data_ptr() for x in (q, k, v, mask, do)]
    assert seen["scale"] == 1.0 / math.sqrt(d)
    assert out[0] is q


@pytest.mark.parametrize("d,w", [(8, 16), (24, 32), (48, 64), (80, 128),
                                 (96, 128), (100, 128)])
def test_other_widths_are_padded_and_cut_back(d, w):
    q, k, v, do, mask = (torch.from_numpy(x) for x in _inputs(d))
    seen = {}

    def fn(q, k, v, mask, do, lse, *, scale):
        seen.update(widths=[x.shape[-1] for x in (q, k, v, do)],
                    mask=mask.shape, lse=lse.shape, scale=scale,
                    tails_zero=all(not x[..., d:].any() for x in (q, k, v, do)),
                    heads_equal=all(torch.equal(x[..., :d], y) for x, y in
                                    zip((q, k, v, do), (qq, kk, vv, dd))))
        return q * 2, lse, torch.zeros(3, 5, w)

    qq, kk, vv, dd = q, k, v, do
    lse = torch.zeros(4, 40)
    o, lse_out, other = tatt.with_kernel_width(fn, q, k, v, mask, do, lse)
    assert seen["widths"] == [w] * 4 and seen["tails_zero"]
    assert seen["heads_equal"] and seen["mask"] == mask.shape
    assert seen["lse"] == lse.shape and seen["scale"] == 1.0 / math.sqrt(d)
    assert o.shape == q.shape and torch.equal(o, q * 2)
    assert lse_out is lse and other.shape == (3, 5, w)  # not a head tensor


def test_widths_past_128_raise():
    assert [tatt.kernel_width(d) for d in (1, 16, 17, 64, 65, 128)] == [
        16, 16, 32, 64, 128, 128]
    with pytest.raises(ValueError, match="up to 128"):
        tatt.kernel_width(129)
    q = torch.zeros(1, 1, 8, 136)
    with pytest.raises(ValueError, match="up to 128"):
        tatt.with_kernel_width(tatt.attention_reference_lse, q, q, q)


def test_bwd_post_reference_sums_the_accumulator_slices():
    # a head's key tiles past the main kernel's grid add into several
    # slices of S_pad rows, which the post-pass sums in slice order
    b, h, s, d = 1, 2, 70, 32
    like = torch.zeros(b, h, s, d)
    slices = torch.randn(b * h, 3, 128, d)
    got = tatt.attention_bwd_post_reference(slices.view(b * h, 3 * 128, d),
                                            like)
    total = (slices[:, 0] + slices[:, 1]) + slices[:, 2]
    want = tatt.attention_bwd_post_reference(total, like)
    assert torch.equal(got, want)


def test_bwd_post_reference_takes_a_padded_accumulator():
    # a 48-wide call's accumulator is 64 wide (the kernel width): its
    # columns past 48 are cut and the scale is the true width's
    b, h, s = 1, 2, 70
    acc = torch.randn(b * h, 128, 64)
    got = tatt.attention_bwd_post_reference(acc, torch.zeros(b, h, s, 48))
    full = tatt.attention_bwd_post_reference(acc, torch.zeros(b, h, s, 64),
                                             scale=1.0 / math.sqrt(48))
    assert got.shape == (b, h, s, 48) and torch.equal(got, full[..., :48])


# ----- an encoder with 128-wide heads from an HF config.json ---------------


@pytest.mark.parametrize("hidden,heads", [(128, 1), (96, 1), (96, 2)])
def test_hf_config_encoder_with_wide_heads_matches_jax(tmp_path, monkeypatch,
                                                       hidden, heads):
    # hidden 128 with 1 head: 128-wide heads, run as they are; 96 with 1
    # or 2 heads: 96 and 48, run as the card runs them, through
    # with_kernel_width around the plain version
    hf = {"model_type": "roberta", "hidden_size": hidden,
          "num_hidden_layers": 2, "num_attention_heads": heads,
          "intermediate_size": 2 * hidden, "max_position_embeddings": 80,
          "vocab_size": 1000}
    (tmp_path / "config.json").write_text(json.dumps(hf))
    args = argparse.Namespace(config_name=None,
                              model_name_or_path=str(tmp_path))
    tenc_cfg = tcli._encoder_config_from_local_hf(args)
    jenc_cfg = jcli._encoder_config_from_local_hf(args)
    assert json.loads(tenc_cfg.to_json()) == json.loads(jenc_cfg.to_json())
    assert tenc_cfg.head_dim == hidden // heads
    tenc_cfg = dataclasses.replace(tenc_cfg, dtype="float32")
    jenc_cfg = dataclasses.replace(jenc_cfg, dtype="float32")
    tc = tcfg.MultimodalConfig(encoder=tenc_cfg, max_seq_length=48)
    jc = jcfg.MultimodalConfig(encoder=jenc_cfg, max_seq_length=48)

    rng = np.random.RandomState(hidden + heads)
    ids = rng.randint(5, 1000, (3, 48)).astype(np.int32)
    ids[:, 0] = 0
    mask = np.ones_like(ids)
    mask[1, 30:] = 0
    ids[mask == 0] = 1
    types = np.zeros_like(ids)
    variables = jax.tree.map(np.asarray, JSequencingModel(jc).init(
        jax.random.PRNGKey(3), jnp.asarray(ids), jnp.asarray(mask),
        jnp.asarray(types)))
    want_seq, want_pooled = JTextEncoder(jc.encoder).apply(
        {"params": variables["params"]["encoder"]}, jnp.asarray(ids),
        jnp.asarray(mask), jnp.asarray(types))

    calls = []
    plain = tenc.multihead_attention

    def padded_route(q, k, v, mask=None, dropout_p=0.0, seed=None,
                     index=None):
        calls.append(q.shape[-1])
        assert dropout_p == 0.0
        return tatt.with_kernel_width(tatt.attention_reference, q, k, v,
                                      mask)

    if hidden // heads != 128:
        monkeypatch.setattr(tenc, "multihead_attention", padded_route)
    state = params_from_jax(variables, tc)
    enc = tenc.TextEncoder(tc.encoder)
    enc.load_state_dict({key[len("encoder."):]: val
                         for key, val in state.items()
                         if key.startswith("encoder.")})
    with torch.inference_mode():
        seq, pooled = enc.eval()(*(torch.from_numpy(x).long()
                                   for x in (ids, mask, types)))
    assert calls == ([] if hidden // heads == 128 else
                     [hidden // heads] * 2)
    assert tenc.multihead_attention is (plain if hidden // heads == 128
                                        else padded_route)
    for name, got, want in (("sequence", seq, want_seq),
                            ("pooled", pooled, want_pooled)):
        _close(got.numpy(), want, name)


# ----- the bf16 main kernel's schedule --------------------------------------

# dQ slots of a lane: partials its consumer may leave before its writer has
# added them, as csrc/flash_bwd.cu defines them
SLOTS = int(re.search(
    r"constexpr int DQ_SLOTS = (\d+);",
    (Path(tatt.__file__).resolve().parent / "csrc" / "flash_bwd.cu")
    .read_text()).group(1))


def _lane_items(lane, lanes, n_items):
    """The items lane `lane` of `lanes` takes, in its order."""
    return range(lane, n_items, lanes)


def _consumer_program(lane, lanes, n_items, n_qt):
    """The actions of a lane's consumer warpgroup (csrc/flash_bwd.cu), in its
    order: for each of its items, for each step, it waits for a free dQ
    slot (the writer has given back the partial of `SLOTS` steps before),
    then leaves the step's partial there and goes on at once."""
    c = 0
    for j in _lane_items(lane, lanes, n_items):
        for i in range(n_qt):
            yield ("slot", c, None)
            yield ("deposit", c, j)
            c += 1


def _writer_program(lane, lanes, n_items, n_qt, n_g):
    """The adds of a lane's dq-writer warp, in its order (the consumer's
    order of steps): it waits for the step's partial to be in its slot,
    then for its q tile's turn; it adds; it gives the slot back once the
    add has read it, and passes the turn on once the add is complete. Keys
    (bh, group, tile)."""
    c = 0
    for j in _lane_items(lane, lanes, n_items):
        bh, kt = divmod(j, n_qt)
        grp = kt // n_g
        for i in range(n_qt):
            tile, count, nxt = tatt.bwd_turn(kt, i, n_qt, n_g)
            yield ("deposited", c, None)
            yield ("wait", (bh, grp, tile), count)
            yield ("add", (bh, grp, tile), kt)
            yield ("free", c, None)
            yield ("set", (bh, grp, tile), nxt)
            c += 1


def _simulate(n_bh, n_qt, blocks, per_block, seed, groups=None):
    """Runs the consumer and the writer of every lane of the cooperative
    grid (`blocks` blocks of `per_block` lanes, all resident at once; lane w
    of block b is lane w * blocks + b) in an order drawn from `seed`: at
    each turn a random program whose next action can go takes it, so a
    writer may lag its consumer by up to SLOTS partials. Returns (the adds
    of each (bh, group, tile) in the order they came, the counters at the
    end, the (bh, group) of each lane's items, the most items a block held
    at once, the most partials a writer held), or None when no program can
    go before all are done (a wait that never ends)."""
    lanes = blocks * per_block
    groups = groups or tatt.bwd_groups(n_qt, lanes)
    n_g = -(-n_qt // groups)
    n_items = n_bh * n_qt
    programs = {}
    for lane in range(lanes):
        programs[("consumer", lane)] = _consumer_program(lane, lanes, n_items,
                                                         n_qt)
        programs[("writer", lane)] = _writer_program(lane, lanes, n_items,
                                                     n_qt, n_g)
    nxt = {key: next(prog, None) for key, prog in programs.items()}
    deposits = defaultdict(int)  # per lane: partials left in slots
    freed = defaultdict(int)     # per lane: slots given back
    counters = defaultdict(int)
    adds = defaultdict(list)
    runs = {lane: [(j // n_qt, j % n_qt // n_g)
                   for j in _lane_items(lane, lanes, n_items)]
            for lane in range(lanes)}
    # per block: the items started and not yet finished (all adds in)
    held = defaultdict(set)
    most_held, most_lag = 0, 0
    rnd = random.Random(seed)

    def ready(key, action):
        kind, arg, val = action
        lane = key[1]
        if kind == "slot":
            return arg < freed[lane] + SLOTS
        if kind == "deposited":
            return deposits[lane] > arg
        if kind == "wait":
            return counters[arg] == val
        return True

    while any(a is not None for a in nxt.values()):
        can = [key for key, a in nxt.items() if a is not None
               and ready(key, a)]
        if not can:
            return None
        key = rnd.choice(sorted(can))
        kind, arg, val = nxt[key]
        lane, block = key[1], key[1] % blocks
        if kind == "deposit":
            deposits[lane] += 1
            held[block].add(val)
            most_held = max(most_held, len(held[block]))
            most_lag = max(most_lag, deposits[lane] - freed[lane])
        elif kind == "set":
            counters[arg] = val
        elif kind == "add":
            adds[arg].append(val)
        elif kind == "free":
            freed[lane] += 1
            if freed[lane] % n_qt == 0:  # the item's last add is in
                j = _lane_items(lane, lanes, n_items)[freed[lane] // n_qt - 1]
                held[block].discard(j)
        nxt[key] = next(programs[key], None)
    return adds, counters, runs, most_held, most_lag


def _expected_adds(n_bh, n_qt, groups):
    """Each q tile's adds in each group: from key tile kt at step
    (tile - kt) mod n_qt, so in order of that step."""
    n_g = -(-n_qt // groups)
    want = {}
    for bh in range(n_bh):
        for tile in range(n_qt):
            for grp in range(groups):
                kts = [kt for kt in range(grp * n_g, min(n_qt, (grp + 1) * n_g))]
                if kts:
                    want[(bh, grp, tile)] = sorted(
                        kts, key=lambda kt: (tile - kt) % n_qt)
    return want


@pytest.mark.parametrize("per_block", [1, 2])
@pytest.mark.parametrize("blocks,n_bh,n_qt", [
    (3, 4, 1), (3, 2, 2), (3, 3, 3), (3, 2, 4), (3, 2, 7), (3, 1, 10),
    (7, 3, 5), (7, 2, 7), (7, 2, 8), (7, 2, 16), (7, 1, 30)])
def test_bwd_schedule_waits_end_and_add_order_is_fixed(blocks, n_bh, n_qt,
                                                       per_block):
    # one lane a block (D = 128) or two (D <= 64), so that a block holds
    # two items at once
    lanes = blocks * per_block
    groups = tatt.bwd_groups(n_qt, lanes)
    n_g = -(-n_qt // groups)
    assert n_g <= lanes and (groups == 1) == (n_qt <= lanes)
    want = _expected_adds(n_bh, n_qt, groups)
    lags, held = set(), set()
    for seed in range(25):
        res = _simulate(n_bh, n_qt, blocks, per_block, seed)
        assert res is not None, f"a wait never ended (order {seed})"
        adds, counters, runs, most_held, most_lag = res
        assert dict(adds) == want, f"order {seed}"
        # every counter is back at 0, ready for the next launch
        assert all(v == 0 for v in counters.values())
        # no lane holds two items of one group
        assert all(len(set(r)) == len(r) for r in runs.values())
        assert most_held <= 2 * per_block and most_lag <= SLOTS
        lags.add(most_lag)
        held.add(most_held)
    if per_block == 2 and n_bh * n_qt > blocks:
        # in some orders a block held an item on each of its lanes at once
        assert max(held) >= 2
    # where a lane has two steps or more, writers lagged their consumers by
    # both slots in some orders
    if -(-n_bh * n_qt // lanes) * n_qt >= SLOTS:
        assert SLOTS in lags


@pytest.mark.parametrize("blocks,n_qt", [(2, 6), (3, 9)])
def test_bwd_schedule_model_sees_a_wait_that_cannot_end(blocks, n_qt):
    # the model finds a stall: one group of more key tiles than the grid
    # holds lanes (groups = 1 where bwd_groups asks for 2) puts key tiles
    # 0 and G of a head on lane 0; tile 0's add at step G waits for tile
    # G's first add, which lane 0 starts only when tile 0's partials are all
    # in slots and a slot is free, and tile 0's two adds from step G on
    # hold both slots
    lanes = 2 * blocks
    assert tatt.bwd_groups(n_qt, lanes) == 2 and n_qt >= lanes + 2
    stalls = [_simulate(1, n_qt, blocks, 2, seed, groups=1) is None
              for seed in range(10)]
    assert all(stalls)
    # with the groups bwd_groups asks for, the same heads finish
    assert _simulate(1, n_qt, blocks, 2, 0) is not None


def test_bwd_turn_counts_the_adds_before_each():
    # the count is the position of the add among the tile's adds of its
    # group, and `next` passes the turn on (0 after the last)
    for n_qt, n_g in ((5, 5), (7, 3), (10, 4), (1, 1), (6, 6), (9, 2)):
        for kt in range(n_qt):
            a = kt // n_g * n_g
            group = range(a, min(n_qt, a + n_g))
            for i in range(n_qt):
                tile, count, nxt = tatt.bwd_turn(kt, i, n_qt, n_g)
                assert tile == (kt + i) % n_qt
                before = [k for k in group if (tile - k) % n_qt < i]
                assert count == len(before)
                assert nxt == (0 if count + 1 == len(group) else count + 1)
