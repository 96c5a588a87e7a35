from .model import (DAC, DACConfig, decode_codes, decoder_forward,
                    encoder_forward, init_decoder_params, init_params,
                    quantize)

__all__ = ["DAC", "DACConfig", "decode_codes", "decoder_forward",
           "encoder_forward", "init_decoder_params", "init_params",
           "quantize"]
