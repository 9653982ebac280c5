"""PyTorch/CUDA port of face_detection_multi_scale_tpu.

The same detector as the JAX package beside it, written for an NVIDIA
Hopper card: plain tensor code in PyTorch, and each Pallas kernel of the
JAX package as a hand-written CUDA kernel (csrc/). Subpackages mirror the
JAX package's names (models/, ops/, infer/, data/, utils/) so that each
module's counterpart is easy to find. Nothing here imports JAX or the JAX
package. Entry points run on the card unless given device="cpu".
"""
