"""OmChat `trust_remote_code` anyres image processor — standalone numpy/PIL.

Shipped inside checkpoints exported by omchat-tpu (see modeling_omchat.py
header).  Behavioral contract (identical to omchat_torch.processing.anyres /
clip_preprocess, which golden-test against the reference's
hf/image_processing_omchat.py:424-733):

1. pick the best grid resolution from `image_grid_pinpoints` (maximize
   effective resolution, tie-break minimum waste, exact int() truncation),
2. aspect-preserving resize + black center-pad, cut into raster-order
   `crop_size` squares,
3. prepend a plain square thumbnail of the original image,
4. CLIP-preprocess each tile (shortest-edge resize, center-crop, 1/255
   rescale, ImageNet normalize),
5. zero-pad the patch dimension across the batch.

`preprocess(images)` returns `{"pixel_values": [B, maxP, 3, crop, crop]
float32, "num_patches": [B] int64}`.
"""

import math
from typing import List, Sequence, Tuple, Union

import numpy as np
from PIL import Image
from transformers.image_processing_utils import BaseImageProcessor, BatchFeature

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def select_best_resolution(original_size, possible_resolutions):
    ow, oh = original_size
    best_fit, max_eff, min_waste = None, 0, float("inf")
    for width, height in possible_resolutions:
        scale = min(width / ow, height / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        waste = width * height - eff
        if eff > max_eff or (eff == max_eff and waste < min_waste):
            max_eff, min_waste, best_fit = eff, waste, (width, height)
    return best_fit


def _resize_and_pad(image: Image.Image, target: Tuple[int, int]) -> Image.Image:
    ow, oh = image.size
    tw, th = target
    scale_w, scale_h = tw / ow, th / oh
    if scale_w < scale_h:
        nw, nh = tw, min(math.ceil(oh * scale_w), th)
    else:
        nw, nh = min(math.ceil(ow * scale_h), tw), th
    resized = image.resize((nw, nh))
    out = Image.new("RGB", (tw, th), (0, 0, 0))
    out.paste(resized, ((tw - nw) // 2, (th - nh) // 2))
    return out


def _divide_to_patches(image: Image.Image, patch: int) -> List[Image.Image]:
    w, h = image.size
    return [
        image.crop((j, i, j + patch, i + patch))
        for i in range(0, h, patch)
        for j in range(0, w, patch)
    ]


def _resize_shortest_edge(size, shortest_edge):
    height, width = size
    short, long = (width, height) if width <= height else (height, width)
    new_long = int(shortest_edge * long / short)
    return (new_long, shortest_edge) if width <= height else (shortest_edge, new_long)


def _center_crop(arr: np.ndarray, ch: int, cw: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top, left = (h - ch) // 2, (w - cw) // 2
    if top >= 0 and left >= 0 and top + ch <= h and left + cw <= w:
        return arr[top : top + ch, left : left + cw]
    nh, nw = max(ch, h), max(cw, w)
    out = np.zeros((nh, nw) + arr.shape[2:], dtype=arr.dtype)
    pt, pl = (nh - h) // 2, (nw - w) // 2
    out[pt : pt + h, pl : pl + w] = arr
    top, left = (nh - ch) // 2, (nw - cw) // 2
    return out[top : top + ch, left : left + cw]


class OmChatImageProcessor(BaseImageProcessor):
    model_input_names = ["pixel_values", "num_patches"]

    def __init__(
        self,
        crop_size=None,
        size=None,
        image_grid_pinpoints=None,
        image_mean=IMAGENET_MEAN,
        image_std=IMAGENET_STD,
        rescale_factor=1 / 255,
        **kwargs,
    ):
        super().__init__(**kwargs)
        if isinstance(crop_size, dict):
            crop_size = crop_size.get("height", 448)
        self.crop_size = crop_size or 448
        if isinstance(size, dict):
            size = size.get("shortest_edge", self.crop_size)
        self.size = size or self.crop_size
        self.image_grid_pinpoints = image_grid_pinpoints or [
            [448, 896], [896, 448], [896, 896], [1344, 448], [448, 1344], [1344, 1344]
        ]
        self.image_mean = list(image_mean)
        self.image_std = list(image_std)
        self.rescale_factor = rescale_factor

    def _preprocess_tile(self, pil: Image.Image) -> np.ndarray:
        if pil.mode != "RGB":
            pil = pil.convert("RGB")
        h, w = _resize_shortest_edge((pil.height, pil.width), self.size)
        if (h, w) != (pil.height, pil.width):
            pil = pil.resize((w, h), resample=Image.Resampling.BICUBIC)
        arr = _center_crop(np.asarray(pil), self.crop_size, self.crop_size)
        arr = arr.astype(np.float32) * np.float32(self.rescale_factor)
        arr = (arr - np.asarray(self.image_mean, np.float32)) / np.asarray(self.image_std, np.float32)
        return arr.transpose(2, 0, 1).astype(np.float32)

    def _process_one(self, image: Image.Image) -> np.ndarray:
        best = select_best_resolution(image.size, self.image_grid_pinpoints)
        padded = _resize_and_pad(image, best)
        tiles = [image.resize((self.crop_size, self.crop_size))] + _divide_to_patches(
            padded, self.crop_size
        )
        return np.stack([self._preprocess_tile(t) for t in tiles], axis=0)

    def preprocess(self, images: Union[Image.Image, Sequence[Image.Image]], **kwargs) -> BatchFeature:
        if isinstance(images, Image.Image):
            images = [images]
        per_image = [self._process_one(im) for im in images]
        num_patches = np.asarray([p.shape[0] for p in per_image], dtype=np.int64)
        max_p = int(num_patches.max())
        out = np.zeros((len(per_image), max_p, 3, self.crop_size, self.crop_size), np.float32)
        for i, p in enumerate(per_image):
            out[i, : p.shape[0]] = p
        return BatchFeature(
            data={"pixel_values": out, "num_patches": num_patches},
            tensor_type=kwargs.get("return_tensors"),
        )
