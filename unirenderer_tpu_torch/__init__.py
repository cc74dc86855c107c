"""unirenderer_tpu_torch: the PyTorch/CUDA port of `unirenderer_tpu`.

The JAX package stays the reference; this package re-implements its
sampling API (`UniRendererPipeline`: forward and inverse rendering,
joint sampling, the legacy layouts, relighting), its split-sum renderer
and render collate, and its trainer, in PyTorch for an NVIDIA H100, with
the TPU kernels on those paths written by hand in CUDA (`csrc/`).
Module names mirror the JAX package:

    core/       configs (own copy), npz reader, flax -> torch weight converter
    diffusion/  DDPM x0 schedule, the UniPC and DDIM sampler steps
    ops/        kernel wrappers (GroupNorm+SiLU, flash attention and the
                splash / unet_flash attention routes, the tile
                rasterizer), the nvcc build of `csrc/*.cu`, and the
                renderer's transforms, textures and cubemaps
    models/     nn.Modules: layers, UNet blocks, CLIP text, VAE, dual stream
    render/     meshes, cameras, environment lights, `render_mesh`
    data/       datasets, the render collate, the synthetic data generator
    eval/       metrics and the held-out harness (forward and inverse legs)
    pipelines   UniRendererPipeline (one sampling engine, every mode)

Public functions keep the JAX package's NHWC / (B, S, H, D) layouts.
Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`; on the CPU every kernel wrapper runs its plain PyTorch
version.  Nothing here imports JAX.
"""
