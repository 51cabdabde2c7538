"""Every traffic mix gives the same inputs for one seed and other inputs,
of the same shapes, for another; the training pool is cut as the port's
token sampler cuts it."""
import numpy as np
import pytest
import torch

from harness import cell as C, traffic as T
from harness.kinds.train import token_batch_size

SEEDS = (2**31 + 5, 2**31 + 6)
WORKLOADS = ["ls960h-train", "ls960h-transcribe-greedy", "wmt17-translate-beam5"]


def cell(workload):
    return C.make_cell(C.benchmark(), workload, SEEDS[0], 1.0, False, "cpu")


def pool(c):
    return T.token_batches(c.traffic, token_batch_size(c.config["training"]))


def requests(c):
    size = c.config["testing"]["batch_size"]
    if c.traffic["kind"] == "transcribe":
        return T.speech_requests(c.traffic, size)
    return T.text_requests(c.traffic, size)


def inputs(workload, seed):
    c = cell(workload)
    if c.traffic["kind"] == "train":
        shapes = pool(c)
        small = [(min(f, 300), n) for f, n in shapes[0][:4]]
        raw = T.speech_train_batch(small, seed, 0, 10000, 80, "cpu")
        return T.order(len(shapes), seed), raw["src"], raw["trg"]
    if c.traffic["kind"] == "transcribe":
        n = torch.tensor([16000, 24000])
        return T.order(len(requests(c)), seed), T.speechlike(n, T.stream(seed, 100), "cpu")
    return T.order(len(requests(c)), seed), T.source_ids(requests(c)[0][:64], seed, 0, 32000,
                                                         "cpu")


def same(a, b):
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("workload", WORKLOADS)
def test_seed_decides_inputs(workload):
    one, again = inputs(workload, SEEDS[0]), inputs(workload, SEEDS[0])
    other = inputs(workload, SEEDS[1])
    assert all(same(a, b) for a, b in zip(one, again))
    tensors = [(a, b) for a, b in zip(one, other) if isinstance(a, torch.Tensor)]
    assert all(a.shape == b.shape for a, b in tensors)
    assert any(not torch.equal(a, b) for a, b in tensors)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sizes_do_not_follow_the_seed(workload):
    c = cell(workload)
    if c.traffic["kind"] == "train":
        assert pool(c) == pool(cell(workload))
        assert sorted(T.order(8, SEEDS[0])) == list(range(8))
    elif c.traffic["kind"] == "transcribe":
        a, b = requests(c), requests(cell(workload))
        assert [len(r) for r in a] == [1024, 1024, 572]
        assert all((x == y).all() for x, y in zip(a, b))
    else:
        (a,) = requests(c)
        assert len(a) == 3004 and a.min() >= 1 and a.max() <= 100


def test_train_pool_is_two_published_updates():
    c = cell("ls960h-train")
    assert token_batch_size(c.config["training"]) == 2 * 20000 * 8
    for batch in pool(c):
        def padded(rows):
            return max(max(f, n) + 1 for f, n in rows) * len(rows)

        assert padded(batch) >= 320000 > padded(batch[:-1])
        assert all(100 <= f <= 2450 for f, _ in batch)


def test_train_pool_is_cut_as_the_port_cuts_it():
    """The frozen copy of the cutting rule gives the batches that the port's
    ``TokenBatchSampler`` gives over the same lengths, in the same order."""
    from joeys2t_torch.data.samplers import TokenBatchSampler

    c = cell("ls960h-train")
    batches = pool(c)
    rows = [r for b in batches for r in b]

    class Source:
        def __getitem__(self, i):
            frames, ids = rows[i]
            return None, np.zeros(frames), np.zeros(ids)

    class InOrder:
        data_source = Source()

        def __iter__(self):
            return iter(range(len(rows)))

    sampler = TokenBatchSampler(InOrder(), token_batch_size(c.config["training"]),
                                drop_last=True, seed=0)
    got = [[rows[i] for i in b] for b in sampler]
    assert got == batches


def test_laws_keep_their_range():
    rng = np.random.default_rng(0)
    x = T.draw({"law": "lognormal", "mean": 7.4, "sigma": 0.6, "min": 1.3, "max": 35.0},
               20000, rng)
    assert x.min() >= 1.3 and x.max() <= 35.0 and abs(x.mean() - 7.4) < 0.3
