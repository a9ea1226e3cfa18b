from fourierdiffusion_tpu_torch.ops.fourier import dft, idft, n_real_components

__all__ = ["dft", "idft", "n_real_components"]
