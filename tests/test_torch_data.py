"""Port parity of the data pipeline: ``repro_torch.data`` against
``repro.data``.

``SyntheticLM`` and ``MemmapCorpus`` make the reference's numpy draws
(PCG64 from ``SeedSequence([seed, step, shard])``), so every batch equals
the reference's bit for bit.  The audio and vlm configs are built in the
port from the reference's fields (the port registers the dense family
only): ``batch_spec_for`` and the frame/patch stubs need nothing else.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.data import BatchSpec as JBatchSpec
from repro.data import MemmapCorpus as JMemmapCorpus
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import batch_spec_for as jbatch_spec_for
from repro.models import config as JC
from repro.models.config import ArchConfig as JArchConfig
from repro_torch.data import (BatchSpec, MemmapCorpus, SyntheticLM,
                              batch_spec_for, global_batch)
from repro_torch.models.config import ArchConfig

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, attn_chunked_above=10 ** 9,
            dtype="float32")


def _port_config(jcfg):
    return ArchConfig(**dataclasses.asdict(jcfg))


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", (0, 3))
def test_synthetic_lm_equals_the_reference_bit_for_bit(seed):
    jcfg, cfg = JArchConfig(**TINY), ArchConfig(**TINY)
    for step in (0, 5, 1000):
        _equal(SyntheticLM(cfg, BatchSpec(8, 16), seed=seed)(step),
               JSyntheticLM(jcfg, JBatchSpec(8, 16), seed=seed)(step))
        for shard in range(4):
            _equal(SyntheticLM(cfg, BatchSpec(8, 16), seed=seed, shard=shard,
                               num_shards=4)(step),
                   JSyntheticLM(jcfg, JBatchSpec(8, 16), seed=seed,
                                shard=shard, num_shards=4)(step))


@pytest.mark.parametrize("arch,seq", (("seamless-m4t-medium", 32),
                                      ("qwen2-vl-2b", 512)))
def test_frame_and_patch_stubs_equal_the_reference(arch, seq):
    jcfg = JC.get(arch)
    cfg = _port_config(jcfg)
    spec = batch_spec_for(cfg, 2, seq)
    assert dataclasses.asdict(spec) == dataclasses.asdict(
        jbatch_spec_for(jcfg, 2, seq))
    got = SyntheticLM(cfg, spec, seed=1)(2)
    want = JSyntheticLM(jcfg, jbatch_spec_for(jcfg, 2, seq), seed=1)(2)
    _equal(got, want)
    if cfg.family == "audio":
        assert got["frames"].shape == (2, seq, cfg.d_model)
    else:
        assert got["patches"].shape[1] + got["tokens"].shape[1] == seq


def test_batch_spec_for_every_family_equals_the_reference():
    families = set()
    for name in JC.available():
        jcfg = JC.get(name)
        families.add(jcfg.family)
        for batch, seq in ((2, 32), (8, 4096)):
            assert dataclasses.asdict(
                batch_spec_for(_port_config(jcfg), batch, seq)) == \
                dataclasses.asdict(jbatch_spec_for(jcfg, batch, seq)), name
    assert families == {"dense", "moe", "hybrid", "ssm", "audio", "vlm"}


def test_memmap_corpus_equals_the_reference(tmp_path):
    path = tmp_path / "corpus.bin"
    rng = np.random.default_rng(0)
    rng.integers(0, 1000, 10_000, dtype=np.int32).tofile(path)
    jcfg, cfg = JArchConfig(**TINY), ArchConfig(**TINY)
    for shard in (0, 1):
        src = MemmapCorpus(cfg, BatchSpec(4, 32), str(path), seed=2,
                           shard=shard, num_shards=2)
        ref = JMemmapCorpus(jcfg, JBatchSpec(4, 32), str(path), seed=2,
                            shard=shard, num_shards=2)
        for step in (0, 7):
            batch = src(step)
            _equal(batch, ref(step))
            assert batch["tokens"].shape == (2, 32)
            assert batch["tokens"].max() < cfg.vocab_size
            np.testing.assert_array_equal(batch["labels"][:, :-1],
                                          batch["tokens"][:, 1:])
    short = tmp_path / "short.bin"
    np.arange(20, dtype=np.int32).tofile(short)
    with pytest.raises(ValueError, match="shorter"):
        MemmapCorpus(cfg, BatchSpec(4, 32), str(short))


def test_global_batch_places_the_batch_on_the_device():
    cfg = ArchConfig(**TINY)
    src = SyntheticLM(cfg, BatchSpec(4, 16), seed=3)
    batch = global_batch(src, 5, device="cpu")
    for k, v in src(5).items():
        assert isinstance(batch[k], torch.Tensor) and batch[k].is_contiguous()
        assert batch[k].device.type == "cpu" and batch[k].dtype == torch.int32
        np.testing.assert_array_equal(batch[k].numpy(), v)


def test_global_batch_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    src = SyntheticLM(ArchConfig(**TINY), BatchSpec(2, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        global_batch(src, 0)


# ------------------------------------ the reference's tests, on the port
def test_synthetic_data_deterministic_and_sharded():
    cfg = ArchConfig(**TINY)
    spec = BatchSpec(batch=8, seq=16)
    a = SyntheticLM(cfg, spec, seed=3)(5)
    b = SyntheticLM(cfg, spec, seed=3)(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = SyntheticLM(cfg, spec, seed=3)(6)
    assert not np.array_equal(a["tokens"], c["tokens"])
    shards = [SyntheticLM(cfg, spec, seed=3, shard=i, num_shards=4)(5)
              for i in range(4)]
    assert all(s["tokens"].shape == (2, 16) for s in shards)
    assert len({s["tokens"].tobytes() for s in shards}) == 4
    with pytest.raises(ValueError, match="shards"):
        SyntheticLM(cfg, BatchSpec(batch=6, seq=16), num_shards=4)
