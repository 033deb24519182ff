from repro_torch.data.pipelines import (
    TokenStream, GraphBatcher, RecsysBatcher, synthetic_lm_batch)
