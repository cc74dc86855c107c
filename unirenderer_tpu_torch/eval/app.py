"""The decomposition app's backend (counterpart of
`unirenderer_tpu/eval/app.py`): upload -> box / point prompt or mask ->
segment -> ensemble inverse rendering -> the maps; and relight under an
uploaded environment.  Two frontends share one numpy-level `AppBackend`:

  * `python -m unirenderer_tpu_torch.eval.http_app`: a stdlib HTTP page;
  * `build_app()`: a gradio UI, when gradio is installed.

Segmentation follows `eval/segmentation.py`: an uploaded mask (any
external segmenter, SAM2 included), the box-prompt or point-prompt
heuristic, or the white-background heuristic.

Every request draws its noise from a fresh `torch.Generator` seeded 0 on
the pipeline's device, so a repeated request gives the same maps (the JAX
app uses `key(0)` per call; the two draw different numbers).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from unirenderer_tpu_torch.eval.segmentation import (
    auto_mask, box_prompt_mask, point_prompt_mask,
)

MAP_NAMES = ("albedo", "normal", "metallic", "roughness",
             "spec_light", "diff_light")


def _u8(x01: np.ndarray) -> np.ndarray:
    return np.asarray(np.clip(x01, 0, 1) * 255, np.uint8)


class AppBackend:
    """uint8 images in, uint8 maps out, around a `UniRendererPipeline`
    (any config, any weights); both frontends call exactly `decompose` and
    `relight`.  With no pipe: flagship() with random weights (generator
    seeded 0) in bf16 on `device`."""

    def __init__(self, pipe=None, steps: int = 20, ensemble: int = 5,
                 device="cuda"):
        if pipe is None:
            from unirenderer_tpu_torch.core import config
            from unirenderer_tpu_torch.pipelines import UniRendererPipeline
            pipe = UniRendererPipeline.create(
                config.flagship(),
                torch.Generator(device=device).manual_seed(0),
                device=device, dtype=torch.bfloat16)
        self.pipe = pipe
        self.steps = steps
        self.ensemble = ensemble
        self.size = pipe.cfg.vae.sample_size

    # -- helpers -----------------------------------------------------------

    def _resize(self, img_u8: np.ndarray) -> np.ndarray:
        """RGB float32 in [0, 1] at the working resolution (Pillow's
        bilinear filter)."""
        from PIL import Image
        img = Image.fromarray(np.asarray(img_u8, np.uint8)).convert("RGB")
        img = img.resize((self.size, self.size), Image.BILINEAR)
        return np.asarray(img, np.float32) / 255.0

    def make_mask(self, img01: np.ndarray,
                  mask_u8: Optional[np.ndarray],
                  box_text: Optional[str],
                  point_text: Optional[str] = None,
                  orig_hw: Optional[tuple] = None) -> np.ndarray:
        """(H, W, 3) mask in {0, 1}: the uploaded mask, else the box
        prompt, else the point prompt, else the white-background
        heuristic.  Prompt coordinates are in the uploaded image's pixels
        when `orig_hw` is given, and scaled to the working resolution
        here (a negative pair, a background click, keeps its sign)."""
        if mask_u8 is not None:
            m = self._resize(mask_u8)[..., 0]
            return (m > 0.5).astype(np.float32)[..., None].repeat(3, -1)

        def scale(vals):
            vals = [int(v) for v in vals]
            if orig_hw is None:
                return vals
            oh, ow = orig_hw
            sx, sy = self.size / ow, self.size / oh
            return [int(round(abs(v) * (sx if i % 2 == 0 else sy)))
                    * (1 if v >= 0 else -1) for i, v in enumerate(vals)]

        if box_text:
            return box_prompt_mask(img01, scale(box_text.split(",")))
        if point_text:
            return point_prompt_mask(img01, scale(point_text.split(",")))
        return auto_mask(img01)

    def _inputs(self, image_u8, mask_u8, box_text, point_text):
        """(image, mask) (1, S, S, 3) in [-1, 1] and a generator seeded 0
        on the pipeline's device."""
        img01 = self._resize(image_u8)
        mask01 = self.make_mask(img01, mask_u8, box_text, point_text,
                                orig_hw=np.asarray(image_u8).shape[:2])
        gen = torch.Generator(device=self.pipe.device).manual_seed(0)
        return (torch.from_numpy(img01 * 2 - 1)[None],
                torch.from_numpy(mask01 * 2 - 1)[None], gen)

    # -- the two app actions ----------------------------------------------

    def decompose(self, image_u8: np.ndarray,
                  mask_u8: Optional[np.ndarray] = None,
                  box_text: Optional[str] = None,
                  point_text: Optional[str] = None
                  ) -> Dict[str, np.ndarray]:
        """image (+ optional mask / box / point prompt) -> the 6 maps as
        (S, S, 3) uint8 (metallic and roughness grey)."""
        image, mask, gen = self._inputs(image_u8, mask_u8, box_text,
                                        point_text)
        out = self.pipe.real_image2mask_3mod_albedo(
            image=image, mask=mask, generator=gen, num_steps=self.steps,
            ensemble=self.ensemble)
        out = {k: v[0].float().cpu().numpy() for k, v in out.items()}
        maps = {k: _u8((out[k] + 1) / 2) for k in MAP_NAMES
                if k not in ("metallic", "roughness")}
        for k in ("metallic", "roughness"):
            maps[k] = _u8(np.repeat(out[k][..., None], 3, -1))
        return {k: maps[k] for k in MAP_NAMES}

    def relight(self, image_u8: np.ndarray,
                mask_u8: Optional[np.ndarray],
                box_text: Optional[str],
                env_u8: Optional[np.ndarray],
                point_text: Optional[str] = None) -> np.ndarray:
        """Decompose (ensemble 1) and render again under the uploaded
        environment, an LDR latlong taken as sRGB (^2.2 to linear) ->
        (S, S, 3) uint8 (`pipelines.relight`)."""
        if env_u8 is None:
            raise ValueError("upload an environment image to relight")
        image, mask, gen = self._inputs(image_u8, mask_u8, box_text,
                                        point_text)
        env01 = (np.asarray(env_u8, np.float32) / 255.0) ** 2.2
        if env01.ndim == 3 and env01.shape[-1] == 4:
            env01 = env01[..., :3]
        relit = self.pipe.relight(
            image=image, mask=mask, new_env=torch.from_numpy(env01),
            generator=gen, num_steps=self.steps, ensemble=1)
        return _u8((relit[0].float().cpu().numpy() + 1) / 2)


def build_app(pipe=None, steps: int = 20, ensemble: int = 5,
              device="cuda"):
    """The gradio frontend over AppBackend (when gradio is installed)."""
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed; use `python -m "
            "unirenderer_tpu_torch.eval.http_app` (stdlib UI) or "
            "`python -m unirenderer_tpu_torch.eval.run_inverse` (CLI)"
        ) from e

    backend = AppBackend(pipe, steps=steps, ensemble=ensemble, device=device)

    def decompose(image, mask_img, box_text, point_text):
        out = backend.decompose(image, mask_img, box_text, point_text)
        return tuple(out[n] for n in MAP_NAMES)

    def relight(image, mask_img, box_text, point_text, env_img):
        return backend.relight(image, mask_img, box_text, env_img,
                               point_text=point_text)

    with gr.Blocks(title="uni-renderer") as demo:
        gr.Markdown("# Uni-Renderer: inverse rendering")
        with gr.Row():
            inp = gr.Image(label="input")
            mask_in = gr.Image(label="mask (optional; see "
                               "eval/segmentation.py for the SAM2 recipe)")
        box_in = gr.Textbox(label="box prompt x0,y0,x1,y1 (optional)")
        pt_in = gr.Textbox(label="point prompt x,y[,x,y...] (optional; "
                           "negative pair = background click)")
        btn = gr.Button("Decompose")
        outs = [gr.Image(label=n) for n in MAP_NAMES]
        btn.click(decompose, inputs=[inp, mask_in, box_in, pt_in],
                  outputs=outs)
        gr.Markdown("## Relight")
        env_in = gr.Image(label="new environment (latlong)")
        rbtn = gr.Button("Relight")
        relit_out = gr.Image(label="relit")
        rbtn.click(relight, inputs=[inp, mask_in, box_in, pt_in, env_in],
                   outputs=[relit_out])
    return demo
