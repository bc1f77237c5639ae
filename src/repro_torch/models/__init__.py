from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.transformer import (ModelOpts, decode_step,
                                            forward_hidden, init_cache,
                                            init_params, logits_fn,
                                            model_spec, prefill)

__all__ = ["ModelOpts", "decode_step", "forward_hidden", "init_cache",
           "init_params", "logits_fn", "model_spec", "prefill",
           "params_from_jax", "params_to_numpy"]
