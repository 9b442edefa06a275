from repro_torch.roofline.analysis import HW, model_flops

__all__ = ["HW", "model_flops"]
