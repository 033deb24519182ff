from repro_torch.core import phases
from repro_torch.core.engine import QueryResult, SsspEngine, bucket_k
from repro_torch.core.partition import inter_edge_counts, partition_1d
from repro_torch.core.shards import (SsspShards, build_shards,
                                    build_shards_stream, shards_from_arrays)
from repro_torch.core.sssp import (SimComm, SsspConfig, SsspStats,
                                   certificate_improved_sim,
                                   dispatches_per_round, init_carry,
                                   make_finalize, make_round)
