from repro_torch.data.pipeline import (TokenDataConfig,
                                       synthetic_token_batches,
                                       make_batch_iterator)

__all__ = ["TokenDataConfig", "synthetic_token_batches",
           "make_batch_iterator"]
