"""triton_dist_tpu_torch: the PyTorch/CUDA port of triton_dist_tpu.

It serves dense Qwen3 models on one NVIDIA Hopper card, or over a
tensor-parallel mesh of ranks (runtime/bootstrap.py), through
hand-written CUDA kernels (kernels/csrc/), with the JAX package's module
names and layouts. It imports neither jax nor triton_dist_tpu.
Entry points (`models.AutoLLM`, `models.DenseLLM.random_init`,
`models.Engine`) run on "cuda" unless the caller passes device="cpu",
where every kernel wrapper takes its plain PyTorch version.
"""
