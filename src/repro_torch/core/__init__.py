from repro_torch.core import phases
from repro_torch.core.faults import FaultPlan, FaultState, wrap_exchange
from repro_torch.core.engine import (QueryHandle, QueryResult, SsspEngine,
                                     bucket_k, engine_for)
from repro_torch.core.partition import inter_edge_counts, partition_1d
from repro_torch.core.shards import (SsspShards, build_shards,
                                    build_shards_stream, shard_distance_rows,
                                    shards_from_arrays)
from repro_torch.core.sssp import (RoundPipeline, ShmapComm, SimComm,
                                   SsspConfig, SsspStats, build_pipeline,
                                   build_shmap_certificate,
                                   build_shmap_solver,
                                   build_shmap_solver_traced,
                                   certificate_improved_sim,
                                   dispatches_per_round, init_carry,
                                   make_finalize, make_round, sim_phase_fns,
                                   solve_shmap,
                                   solve_shmap_batch, solve_sim,
                                   solve_sim_batch)
from repro_torch.core.warmstart import CachedRow, LandmarkCache, ResultCache
