"""Port parity: the six schedules' partitions and the dynamic queues.

The same tile sizes go through ``repro.core`` (JAX) and
``repro_torch.core`` (PyTorch on the CPU); every Partition field must be
integer-equal, span hints and inverted chunk queues included.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro_torch.interop import (partition_from_arrays, partition_to_arrays,
                                 workspec_from_arrays)

from _torch_parity import (SCHEDULES, assert_same_partition, np_of,
                           spec_pair, t32, zoo)


class TestPartitions:
    @pytest.mark.parametrize("num_blocks", [4, 64])
    @pytest.mark.parametrize("schedule,policy", SCHEDULES)
    @pytest.mark.parametrize("name", sorted(zoo()))
    def test_integer_equal(self, name, schedule, policy, num_blocks):
        """Every field, span hints and inverted queues included; 64
        blocks is num_blocks >> num_atoms for most of the zoo."""
        jspec, tspec = spec_pair(zoo()[name])
        jpart = J.make_partition(jspec, schedule, num_blocks,
                                 chunk_policy=policy)
        tpart = T.make_partition(tspec, schedule, num_blocks,
                                 chunk_policy=policy)
        assert_same_partition(jpart, tpart)

    def test_interop_round_trip(self):
        jspec, _ = spec_pair(zoo()["powerlaw"])
        jpart = J.make_partition(jspec, "chunked", 4)
        tpart = partition_from_arrays(partition_to_arrays(jpart),
                                      device="cpu")
        assert_same_partition(jpart, tpart)
        tspec = workspec_from_arrays(np_of(jspec.tile_offsets), device="cpu")
        assert tspec.num_atoms == jspec.num_atoms

    def test_assign_chunks_lpt(self):
        cost = np.asarray([5, 1, 9, 9, 2, 0, 7, 3], np.int32)
        np.testing.assert_array_equal(
            np_of(T.assign_chunks(t32(cost), 3, "lpt")),
            np_of(J.assign_chunks(jnp.asarray(cost), 3, "lpt")))

    def test_adaptive_memo(self):
        _, tspec = spec_pair(zoo()["one_heavy"])
        T.clear_adaptive_cache()
        before = T.adaptive_inspection_count()
        first = T.adaptive_partition(tspec, 4)
        again = T.adaptive_partition(tspec, 4)
        assert again is first
        assert T.adaptive_inspection_count() == before + 1
