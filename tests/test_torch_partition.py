"""The port's per-process partition of a split, and the batch arithmetic of
``parallel/mesh.py``, against the JAX package's: the index lists of
``partition_for_process`` for 0-40 items over 2-4 processes, and
``shard_batch``'s wrap-pad and ``pad_batch_to`` (pure numpy, exact)."""

import numpy as np
import pytest

from ddpm_ood_tpu.data.csv_splits import partition_for_process as jax_partition
from ddpm_ood_tpu.parallel.mesh import pad_batch_to as jax_pad_batch_to
from ddpm_ood_tpu_torch.data.csv_splits import partition_for_process
from ddpm_ood_tpu_torch.parallel import mesh as pmesh


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_partition_for_process_matches_jax(parts):
    for n in range(41):
        data = [{"image": f"img_{i}.npy"} for i in range(n)]
        got = [partition_for_process(data, parts, i) for i in range(parts)]
        assert got == [jax_partition(data, parts, i) for i in range(parts)], n
        if n:  # the wrap-pad makes every partition as long (once there is one item each)
            assert len({len(p) for p in got}) == 1 or n < parts, n


def test_one_partition_is_the_split():
    data = [{"image": str(i)} for i in range(5)]
    assert partition_for_process(data, 1, 0) is data


def test_shard_batch_wrap_pad_matches_jax_arithmetic():
    """``shard_batch``'s local wrap-pad (JAX ``parallel/mesh.py``): a batch
    that the process's device count does not divide repeats its leading
    samples; under DDP that count is 1 and a batch passes unchanged."""
    for data_size, procs in [(8, 1), (8, 2), (4, 4), (2, 4), (1, 1)]:
        multiple = pmesh.local_multiple(data_size, procs)
        assert multiple == max(1, data_size // procs)
        for n in range(1, 13):
            batch = np.arange(n * 3).reshape(n, 3)
            target = -(-n // multiple) * multiple
            want = batch[np.arange(target) % n]
            np.testing.assert_array_equal(pmesh.wrap_pad(batch, multiple), want)
    batch = np.arange(10.0).reshape(5, 2)  # one device a process: unchanged
    np.testing.assert_array_equal(pmesh.wrap_pad(batch, pmesh.local_multiple(2, 2)), batch)


def test_pad_batch_to_matches_jax():
    rng = np.random.default_rng(0)
    for n in range(1, 11):
        for multiple in (1, 2, 3, 4, 8):
            batch = rng.standard_normal((n, 2, 3)).astype(np.float32)
            got, mask = pmesh.pad_batch_to(batch, multiple)
            want, want_mask = jax_pad_batch_to(batch, multiple)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(mask, want_mask)
