"""The port's seekable data pipeline against the reference's
(``repro.data.pipeline``): ``SyntheticTokens`` and ``MemmapCorpus``
batches equal bit for bit (dtype, shape and every token), for several
seeds, steps and host partitions, and the host partitions of a global
batch disjoint and covering it.
"""
import numpy as np
import pytest
import torch

from repro.data import DataConfig as RefDataConfig
from repro.data import MemmapCorpus as RefMemmapCorpus
from repro.data import SyntheticTokens as RefSyntheticTokens
from repro_torch.data import DataConfig, MemmapCorpus, SyntheticTokens

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)

CONFIGS = {
    "smoke": dict(vocab=128, seq_len=32, global_batch=4),
    "odd_seq": dict(vocab=100, seq_len=17, global_batch=6, seed=5),
    "smollm_full": dict(vocab=49152, seq_len=2048, global_batch=8),
    "hosts": dict(vocab=1000, seq_len=16, global_batch=8, seed=3,
                  num_hosts=4, host_id=2),
}


def assert_batches_equal(got, want):
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_synthetic_tokens_equal_the_reference(name):
    kw = CONFIGS[name]
    ours, ref = SyntheticTokens(DataConfig(**kw)), \
        RefSyntheticTokens(RefDataConfig(**kw))
    assert DataConfig(**kw).host_batch == RefDataConfig(**kw).host_batch
    for step in (0, 1, 7, 123_456):
        assert_batches_equal(ours.get_batch(step), ref.get_batch(step))


@pytest.mark.parametrize("name", ["smoke", "odd_seq", "hosts"])
def test_memmap_corpus_equals_the_reference(name, tmp_path):
    kw = CONFIGS[name]
    path = tmp_path / "corpus.npy"
    np.save(path, np.random.default_rng(1).integers(
        0, kw["vocab"], 5_000).astype(np.uint16))
    ours, ref = MemmapCorpus(DataConfig(**kw), str(path)), \
        RefMemmapCorpus(RefDataConfig(**kw), str(path))
    for step in (0, 3, 50, 999):       # the windows wrap the corpus
        assert_batches_equal(ours.get_batch(step), ref.get_batch(step))


@pytest.mark.parametrize("source", ["synthetic", "memmap"])
def test_host_partitions_cover_the_global_batch(source, tmp_path):
    path = tmp_path / "corpus.npy"
    np.save(path, np.arange(3_000, dtype=np.int32) % 97)

    def make(**kw):
        cfg = DataConfig(vocab=97, seq_len=16, global_batch=8, **kw)
        return SyntheticTokens(cfg) if source == "synthetic" \
            else MemmapCorpus(cfg, str(path))

    full = make().get_batch(5)
    for hosts in (2, 4, 8):
        parts = [make(num_hosts=hosts, host_id=h).get_batch(5)
                 for h in range(hosts)]
        for k in full:
            np.testing.assert_array_equal(
                np.concatenate([p[k] for p in parts]), full[k])


def test_host_batch_must_divide():
    with pytest.raises(ValueError):
        DataConfig(vocab=10, seq_len=4, global_batch=6, num_hosts=4
                   ).host_batch
