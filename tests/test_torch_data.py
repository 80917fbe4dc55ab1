"""The port's data pipeline (`repro_torch.data`) against the reference's
(`repro.data`): the same batches, bit for bit, for every key."""

import numpy as np
import pytest

from repro.data import pipeline as rpipe
from repro_torch import data as pdata
from repro_torch.data import pipeline as ppipe

CONFIGS = [
    dict(vocab=512, seq_len=64, global_batch=4),
    dict(vocab=49152, seq_len=256, global_batch=8, seed=3),
    dict(vocab=1000, seq_len=32, global_batch=8, zipf_a=1.5, doc_len_mean=8, eos_id=7),
]
KEYS = [(0, 0, 1), (5, 0, 1), (3, 1, 2), (11, 3, 4)]  # (step, shard, n_shards)


def _equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_synthetic_batch_equals_reference(ci, key):
    step, shard, n_shards = key
    got = ppipe.synthetic_batch(ppipe.DataConfig(**CONFIGS[ci]), step, shard, n_shards)
    want = rpipe.synthetic_batch(rpipe.DataConfig(**CONFIGS[ci]), step, shard, n_shards)
    _equal(got, want)


def test_batch_iterator_equals_reference():
    pit = pdata.make_batch_iterator(pdata.DataConfig(**CONFIGS[0]), start_step=7, shard=1, n_shards=2)
    rit = rpipe.make_batch_iterator(rpipe.DataConfig(**CONFIGS[0]), start_step=7, shard=1, n_shards=2)
    for _ in range(3):
        _equal(next(pit), next(rit))


@pytest.mark.parametrize("step", [0, 1, 9])
def test_binary_corpus_equals_reference(tmp_path, step):
    path = tmp_path / "corpus.bin"
    np.random.default_rng(1).integers(0, 512, 5000).astype(np.int32).tofile(path)
    got = ppipe.read_binary_corpus(str(path), ppipe.DataConfig(**CONFIGS[0]), step)
    want = rpipe.read_binary_corpus(str(path), rpipe.DataConfig(**CONFIGS[0]), step)
    _equal(got, want)


def test_config_fields_match_reference():
    assert [f.name for f in ppipe.dataclasses.fields(ppipe.DataConfig)] == [
        f.name for f in rpipe.dataclasses.fields(rpipe.DataConfig)
    ]
    assert ppipe.DataConfig(vocab=1, seq_len=1, global_batch=1).__dict__ == \
        rpipe.DataConfig(vocab=1, seq_len=1, global_batch=1).__dict__
