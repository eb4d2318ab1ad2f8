"""Input, cache and parameter shapes for the dry-run — the port of
`repro/launch/specs.py`.

Nothing is allocated: every builder returns tensors on the `meta` device
(shape and dtype alone) with the JAX package's shapes and dtypes, in its
pytree order (`tree.tree_flatten`: dict keys sorted). Params and caches
come from the real `SplitModel.init` / `init_cache` on `meta`.

Assigned input shapes:
  train_4k     seq=4096    global_batch=256   (training, SFPrompt phase-2)
  prefill_32k  seq=32768   global_batch=32    (split-inference prefill)
  decode_32k   seq=32768   global_batch=128   (split-inference decode)
  long_500k    seq=524288  global_batch=1     (long-context decode; ring-
               buffer window / native SSM state)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.split import SplitModel
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

VLM_PATCH_FRACTION = 4  # 1/4 of the sequence is image patches


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, *,
                leading: Tuple[int, ...], act_dtype=torch.bfloat16
                ) -> Dict[str, Any]:
    """Model inputs with the given leading dims ((K, b) for per-client
    training, (B,) for serving)."""
    S = shape.seq

    def mk(tail, dt):
        return _meta(tuple(leading) + tail, dt)

    if cfg.arch_type == "vit":
        n_patches = 196
        return {"patches": mk((n_patches, 16 * 16 * 3), act_dtype),
                "labels": mk((), torch.int32)}

    if shape.kind == "decode":
        return {"tokens": mk((1,), torch.int32), "pos": mk((), torch.int32)}

    batch = {}
    if cfg.arch_type == "vlm":
        npz = S // VLM_PATCH_FRACTION
        batch["patch_embeds"] = mk((npz, cfg.d_model), act_dtype)
        batch["mrope_positions"] = mk((3, npz), torch.int32)
        batch["tokens"] = mk((S - npz,), torch.int32)
    elif cfg.arch_type == "audio":
        batch["frames"] = mk((cfg.encoder.n_frames, cfg.d_model), act_dtype)
        batch["tokens"] = mk((S,), torch.int32)
    else:
        batch["tokens"] = mk((S,), torch.int32)
    return batch


def cache_specs(model: SplitModel, shape: ShapeSpec, *,
                dtype=torch.bfloat16, batch=None) -> Any:
    """The decode cache. long_500k uses the arch's ring-buffer window;
    decode_32k keeps the full cache. `batch` (default: the global batch)
    sizes the slot axis, as a rank's block does; on a model `on_mesh` the
    head's and body's caches hold the rank's heads."""
    window = None
    if shape.name == "long_500k":
        window = model.cfg.long_context_window
    return model.init_cache(shape.global_batch if batch is None else batch,
                            shape.seq, dtype=dtype, window=window,
                            device="meta")


def param_specs(model: SplitModel, *, frozen_dtype=torch.bfloat16,
                trainable_dtype=torch.float32) -> Any:
    """Split-model params: frozen segments in bf16, trainable (tail,
    prompt) in f32 master precision."""
    shapes = model.init(torch.Generator(), device="meta")

    def cast(tree, dt):
        return tree_map(lambda s: _meta(tuple(s.shape), dt), tree)

    return {
        "head": cast(shapes["head"], frozen_dtype),
        "body": cast(shapes["body"], frozen_dtype),
        "tail": cast(shapes["tail"], trainable_dtype),
        "prompt": cast(shapes["prompt"], trainable_dtype),
    }


def stack_client_axis(tree: Any, k: int) -> Any:
    return tree_map(lambda s: _meta((k,) + tuple(s.shape), s.dtype), tree)
