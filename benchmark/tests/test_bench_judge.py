"""The compared numbers' arithmetic on hand-made leaf norms."""

import pytest

from benchmark.harness.judge import shares, train_numbers

JOINT = {"encoder.layer_0.attention.query.weight": 0.4,
         "encoder.layer_0.output.weight": 0.6,
         "heatmap_head.pair_out.weight": 0.2}
TOWER_BN = "encoder.visual_model.resnet.bn1.weight"


def _side(joint, tower_bn=1.0):
    grad = dict(joint, **{TOWER_BN: tower_bn})
    return {"losses": [1.0], "grad": grad, "change": dict(grad)}


def test_shares_of_a_gradient_never_taken_are_nought():
    assert shares({"a": 3.0, "b": 4.0}, ["a", "b"]) == {"a": 0.6, "b": 0.8}
    assert shares({"a": 0.0, "b": 0.0}, ["a", "b"]) == {"a": 0.0, "b": 0.0}


@pytest.mark.parametrize("scale", [0.5, 0.9, 1.1])
def test_grad_share_gap_leaves_out_the_tower_and_a_common_scale(scale):
    # the clip factor, or the loss's gradient a tenth off, scales every
    # joint leaf alike; the tower's leaf 50 % off is not looked at
    prog = _side({k: v * scale for k, v in JOINT.items()}, tower_bn=1.5)
    got = train_numbers(prog, _side(JOINT))
    assert got["grad_share_gap"][0] == pytest.approx(0.0, abs=1e-12)
    assert got["grad_gap"][0] > 0.09


def test_grad_share_gap_finds_one_joint_leaf_off():
    bad = dict(JOINT, **{"heatmap_head.pair_out.weight": 0.3})
    got = train_numbers(_side(bad), _side(JOINT))
    ref = shares(JOINT, JOINT)
    prog = shares(bad, JOINT)
    med = ref["encoder.layer_0.attention.query.weight"]
    worst = max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in JOINT)
    assert got["grad_share_gap"][0] == pytest.approx(worst)
    assert got["grad_share_gap"][1] == "heatmap_head.pair_out.weight"
    assert worst > 0.2


def test_grad_share_gap_of_a_state_left_unchanged_is_one():
    # the optimizer's second moment never written: every leaf reads 0
    got = train_numbers(_side({k: 0.0 for k in JOINT}, 0.0), _side(JOINT))
    assert got["grad_share_gap"][0] == pytest.approx(1.0)
