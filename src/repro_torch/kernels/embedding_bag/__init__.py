from repro_torch.kernels.embedding_bag.embedding_bag import (
    embedding_bag_p, embedding_bag_p_plain)
from repro_torch.kernels.embedding_bag.ops import (embedding_bag,
                                                   embedding_bag_jnp)
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
