"""Data pipeline: the port's ``SyntheticTokens`` gives the reference's
batches byte for byte (tokens and the image/audio extras), its
``Prefetcher`` yields steps in order and drains on ``stop()``, and
``to_device`` copies (never aliases) the host batch."""

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.pipeline import SyntheticTokens as RefTokens
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import Prefetcher, SyntheticTokens, to_device

# (label, reference config, port config): stablelm smoke as it is and in
# float32; small configs with cross-attention and an encoder, whose batches
# carry image_embeds / src_frames in the compute dtype (bf16 and f32)
SMALL = dict(vocab_size=97, num_patches=5, vision_embed_dim=12, audio_embed_dim=8, max_src_len=6)


def _configs():
    from repro.configs.base import ModelConfig as RefConfig

    out = [("stablelm smoke", ref_get_config("stablelm-3b", "smoke"),
            get_config("stablelm-3b", "smoke"))]
    out.append(("stablelm smoke f32",
                ref_get_config("stablelm-3b", "smoke").copy(compute_dtype="float32"),
                get_config("stablelm-3b", "smoke").copy(compute_dtype="float32")))
    for label, extra in (("cross-attn bf16", dict(cross_attn_every=2)),
                         ("cross-attn f32", dict(cross_attn_every=2, compute_dtype="float32")),
                         ("encoder bf16", dict(encoder_layers=2)),
                         ("both f32", dict(cross_attn_every=1, encoder_layers=1,
                                           compute_dtype="float32"))):
        out.append((label, RefConfig(**SMALL, **extra), ModelConfig(**SMALL, **extra)))
    return out


CONFIGS = _configs()


@pytest.mark.parametrize("label,rcfg,cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
@pytest.mark.parametrize("step", [0, 7])
def test_batches_are_byte_identical_to_the_reference(label, rcfg, cfg, step):
    want = RefTokens(rcfg, 3, 10, seed=5).batch_at(step)
    got = SyntheticTokens(cfg, 3, 10, seed=5).batch_at(step)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key


def test_extras_follow_the_config():
    cfg = ModelConfig(**SMALL, cross_attn_every=2, encoder_layers=1, compute_dtype="float32")
    batch = SyntheticTokens(cfg, 2, 10, seed=0).batch_at(0)
    assert batch["image_embeds"].shape == (2, 5, 12)
    assert batch["src_frames"].shape == (2, 6, 8)  # min(max_src_len, seq_len)
    assert set(SyntheticTokens(get_config("stablelm-3b", "smoke"), 2, 10).batch_at(0)) == {"tokens"}


def test_prefetcher_yields_steps_in_order_from_start_step_and_stop_drains():
    src = SyntheticTokens(get_config("stablelm-3b", "smoke"), 2, 8, seed=1)
    pf = Prefetcher(src, start_step=4, depth=2)
    try:
        for want in range(4, 9):
            step, batch = pf.next()
            assert step == want
            np.testing.assert_array_equal(batch["tokens"], src.batch_at(want)["tokens"])
        it = iter(pf)
        assert next(it)[0] == 9
    finally:
        pf.stop()
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()  # the filler saw the flag and ended
    # stop() emptied the queue; at most the one put the filler had in flight
    # landed after it, and iteration ends at once
    assert pf.queue.qsize() <= 1
    assert list(pf) == []


def test_to_device_copies_every_leaf_with_its_dtype():
    cfg = ModelConfig(**SMALL, cross_attn_every=2, encoder_layers=1)  # bf16 extras
    host = SyntheticTokens(cfg, 2, 8, seed=2).batch_at(0)
    dev = to_device(host, "cpu")
    assert dev["tokens"].dtype == torch.int32 and dev["image_embeds"].dtype == torch.bfloat16
    np.testing.assert_array_equal(dev["tokens"].numpy(), host["tokens"])
    np.testing.assert_array_equal(dev["src_frames"].float().numpy(),
                                  host["src_frames"].astype(np.float32))
    dev["tokens"] += 1  # a copy: the host batch is untouched
    assert not np.array_equal(dev["tokens"].numpy(), host["tokens"])


@pytest.mark.cuda
def test_to_device_sends_the_batch_to_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    host = SyntheticTokens(get_config("stablelm-3b", "smoke"), 2, 8, seed=2).batch_at(0)
    dev = to_device(host, "cuda")
    torch.cuda.synchronize()
    assert dev["tokens"].is_cuda
    np.testing.assert_array_equal(dev["tokens"].cpu().numpy(), host["tokens"])
