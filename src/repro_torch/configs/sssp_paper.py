"""The paper's own evaluation graphs (§IV.A) as shape models.

Full-scale graphs exist only as shard-shape models for a dry-run; the
executable runs use generated graphs of reduced scale. Cut fractions
encode partition locality: road networks partition well under 1-D
blocks, social/synthetic graphs do not (~random cut). Skew=4 models hot
destination shards.

The reference's ``configs/sssp_paper.py``.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SsspGraphSpec:
    name: str
    n_vertices: int
    n_edges: int
    cut_fraction: float    # share of edges crossing partitions
    tri_per_edge: float    # triangle candidates per local edge
    skew: float = 4.0      # bucket-capacity skew multiplier

    def shard_shapes(self, n_parts: int):
        block = -(-self.n_vertices // n_parts)
        e_shard = -(-self.n_edges // n_parts)
        e_loc = max(int(e_shard * (1 - self.cut_fraction) * 1.15), 8)
        e_cut = max(int(e_shard * self.cut_fraction * 1.15), 8)
        S = max(min(e_cut, int(e_cut * 0.8)), 8)          # unique boundary pairs
        C = max(int(S / max(n_parts - 1, 1) * self.skew), 8)
        T = max(int(e_loc * self.tri_per_edge), 8)
        return dict(block=block, e_loc=e_loc, e_cut=e_cut, S=S, C=C, T=T)


GRAPHS = {
    "graph1": SsspGraphSpec("graph1", 391_529, 873_775, 0.90, 0.5),
    "graph2": SsspGraphSpec("graph2", 23_947_347, 58_333_344, 0.05, 0.3),
    "graph3": SsspGraphSpec("graph3", 3_072_441, 117_185_083, 0.90, 2.0),
    "graph4": SsspGraphSpec("graph4", 41_700_000, 1_470_000_000, 0.95, 1.0),
}
