"""Core: the paper's doubly-pipelined dual-root reduction-to-all + siblings."""

from repro_torch.core.autotune import (AutotuneCache, TuneResult,
                                       candidate_settings, tune)
from repro_torch.core.collectives import (CollectiveConfig, all_reduce,
                                          all_reduce_mean, bucket_sizes,
                                          bucketed_all_reduce,
                                          structured_all_reduce)
from repro_torch.core.cost_model import (COMPRESS_FACTOR, PAPER_HYDRA,
                                         CommModel, best_algorithm,
                                         dptree_time, hier_time,
                                         optimal_blocks, redbcast_time,
                                         ring_time, sptree_time)
from repro_torch.core.dptree import (dptree_allreduce, hier_allreduce,
                                     redbcast_allreduce, ring_allreduce,
                                     sptree_allreduce)
from repro_torch.core.simulator import simulate_allreduce
from repro_torch.core.topology import (HierarchicalTopology, TreeTopology,
                                       as_levels, build_dual_tree,
                                       build_hierarchy, build_single_tree,
                                       expand_tree_over_stripes,
                                       resolve_group_size, resolve_levels,
                                       validate_topology)
from repro_torch.core.transport import LocalTransport
