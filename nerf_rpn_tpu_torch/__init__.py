"""nerf_rpn_tpu_torch — the PyTorch + CUDA port of ``nerf_rpn_tpu``.

The JAX package ``nerf_rpn_tpu`` is the reference; this package mirrors its
module layout so each part has an obvious counterpart:

- ``ops``        box algebra, coders, top-k, NMS (kernel K3: the packed AABB
                 suppression graph), erf-GELU, window attention (kernels K1,
                 K2 and K4), the fused LayerNorm + partition + qkv (kernel
                 K5) and the fused MLP half of a Swin block (kernel K6).
- ``models``     Swin FPN backbone, FPN neck, anchors, anchor RPN head,
                 proposal generation.
- ``train``      the train and eval steps, optimizer state, checkpoints.
- ``cli``        ``run_rpn --mode train|eval|benchmark`` and its plumbing.
- ``data``       datasets, augmentation, batching, synthetic scenes.
- ``evaluation`` AABB Recall / AP.
- ``weights``    flax parameter tree <-> torch ``state_dict``.
- ``kernels``    builds ``csrc/*.cu`` with ``nvcc`` at first use and binds
                 them with ``ctypes``.

The host-side numpy modules (anchors, ``data``, the AABB metrics, the CLI
plumbing) are copies of the JAX package's: nothing here imports jax or
``nerf_rpn_tpu``.
"""

__version__ = "0.1.0"
