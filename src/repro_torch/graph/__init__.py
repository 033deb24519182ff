from repro_torch.graph.structure import (Graph, PartitionedGraph,
                                        csr_from_coo, graph_from_arrays,
                                        graph_to_numpy)
from repro_torch.graph.generators import (GENERATORS, PAPER_GRAPHS,
                                         SCALE_PRESETS, assign_weights,
                                         edge_chunks_of, get_generator,
                                         ogbn_products_graph,
                                         preset_edge_stream, preset_graph,
                                         random_graph, register_generator,
                                         rmat_edge_stream, rmat_graph,
                                         road_grid_graph)
from repro_torch.graph.reference import (bellman_ford_reference,
                                        dijkstra_reference)
