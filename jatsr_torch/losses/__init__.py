from .perceptual import (buggy_frequency_domain_loss, charbonnier_loss,
                         consistency_loss, frequency_domain_loss,
                         latent_perceptual_loss, multi_scale_loss,
                         reconstruction_loss, total_training_loss)

__all__ = ["buggy_frequency_domain_loss", "charbonnier_loss",
           "consistency_loss", "frequency_domain_loss",
           "latent_perceptual_loss", "multi_scale_loss",
           "reconstruction_loss", "total_training_loss"]
