"""NFLR: latent-modulated local INR compression with learned entropy coding
(torch port of brief_pytorch_tpu/nflr; reference
utils/CompressFramework.py:146-642).

Lazy exports keep the light submodules (rans, entropy) importable without
the framework stack.
"""


def __getattr__(name):
    if name in ("ALLCF", "init_compressframework", "eval_performance",
                "params_from_numpy", "params_to_numpy"):
        from brief_pytorch_tpu_torch.nflr import framework
        return getattr(framework, name)
    raise AttributeError(name)


__all__ = ["ALLCF", "init_compressframework", "eval_performance",
           "params_from_numpy", "params_to_numpy"]
