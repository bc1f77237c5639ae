from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.frontend import audio_stub, frontend_shape, vision_stub
from repro_torch.models.moe import moe_ffn, moe_spec
from repro_torch.models.ssm import (init_ssm_state, ssm_chunked, ssm_spec,
                                    ssm_step)
from repro_torch.models.transformer import (ModelOpts, decode_step, encode,
                                            forward_hidden, init_cache,
                                            init_params, logits_fn,
                                            model_spec, prefill)

__all__ = ["ModelOpts", "decode_step", "encode", "forward_hidden",
           "init_cache", "init_params", "logits_fn", "model_spec", "prefill",
           "params_from_jax", "params_to_numpy", "audio_stub",
           "frontend_shape", "vision_stub", "moe_ffn", "moe_spec",
           "init_ssm_state", "ssm_chunked", "ssm_spec", "ssm_step"]
