from .model import DAC, DACConfig, decoder_forward, init_decoder_params

__all__ = ["DAC", "DACConfig", "decoder_forward", "init_decoder_params"]
