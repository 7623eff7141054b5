"""The frozen arithmetic and the frozen generator, pinned at one shape."""

import json
from pathlib import Path

import pytest
import torch

from perfbench import roofline
from perfbench.ref import ssm_lm
from perfbench.traffic import gen

ROOT = Path(__file__).resolve().parents[2]
MAMBA2 = json.loads(
    (ROOT / "perfbench/configs/mamba2-370m.json").read_text())["sizes"]


def test_model_flops_of_mamba2_at_four_layers():
    # 4 x (1024 x (2 x 2048 + 2 x 128 + 32) + 2048 x 1024) + 1024 x 50,288
    assert ssm_lm.matmul_params(MAMBA2) == 77_840_384
    assert roofline.train_flops_per_token(MAMBA2) == 6 * 77_840_384


def test_sc_mac_bound():
    # the three float32 products at the TF32 peak...
    assert roofline.sc_mac_bound_s(2048, 1024, 2048) == pytest.approx(
        6 * 2048 * 1024 * 2048 / 494.7e12)
    # ...or x, w and the output moved once, whichever is longer
    assert roofline.sc_mac_bound_s(2048, 1024, 32) == pytest.approx(
        4 * (2048 * 1024 + 1024 * 32 + 2048 * 32) / 3.35e12)
    assert roofline.PEAK["float32"] == 494.7e12
    assert roofline.PEAK["bfloat16"] == 989.4e12


def test_lm_batch_is_pinned_by_the_seed():
    g = torch.Generator().manual_seed(7)
    b = gen.lm_batch(g, 2, 16, 100, 1.2)
    assert b["inputs"].dtype == b["labels"].dtype == torch.int32
    assert b["inputs"].tolist() == [
        [48, 16, 61, 61, 1, 19, 37, 16, 31, 31, 82, 49, 1, 16, 16, 39],
        [68, 68, 6, 8, 1, 86, 35, 65, 65, 46, 86, 58, 1, 9, 83, 83]]
    assert torch.equal(b["labels"][:, :-1], b["inputs"][:, 1:])
    assert b["labels"][:, -1].tolist() == [gen.BOS, gen.BOS]


def test_zipf_tokens_skew_low_and_skip_the_specials():
    g = torch.Generator().manual_seed(7)
    assert gen.zipf_tokens(g, (8,), 50280, 1.2).tolist() == [
        23733, 7237, 30495, 30366, 8745, 18012, 7601, 28866]
    toks = gen.zipf_tokens(torch.Generator().manual_seed(1), (100_000,),
                           50280, 1.2)
    assert int(toks.min()) >= 2 and int(toks.max()) < 50280
    assert float((toks < 25140).float().mean()) > 0.5
