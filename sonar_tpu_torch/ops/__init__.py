from .resample import UPSCALE_METHODS, scale_samples

__all__ = ["UPSCALE_METHODS", "scale_samples"]
