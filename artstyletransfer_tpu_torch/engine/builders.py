"""Reference-API representation/loss builders.

The port of the JAX package's ``engine/builders.py``: class-for-class
equivalents of the reference's RepresentationBuilder (reference
neural_style_transfer.py:39-63) and LossBuilder (reference
neural_style_transfer.py:66-112) for users migrating from it. The engine's
hot path does not go through these (it uses the lane-batched loss of
engine/transfer.py); they are a thin API over the same ops, and autograd
runs through them.

Differences from the reference, by design (the JAX package's):
- images are preprocessed NHWC tensors (utils/image.py), one image per
  call (a batch of one)
- the "neural net" is (params, feature_fn) instead of a torch Module:
  params are device weights as models/weights.py's params_from_jax or
  shared_params make them
- the per-step random noise on the content target is reproduced
  (including its noise_power = 0 default, reference
  neural_style_transfer.py:91-93) but takes an explicit torch.Generator

On a CUDA tensor the Gram runs the Gram kernel (and its backward) and
total_variation the TV forward kernel; on a CPU tensor their plain
versions.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from ..models.vgg19 import extract_features
from ..ops.gram import gram_matrix
from ..ops.tv import total_variation


class RepresentationBuilder:
    """Content/style representations from a network's feature taps
    (reference neural_style_transfer.py:39-63)."""

    def __init__(self, image: torch.Tensor, params,
                 feature_fn=extract_features):
        self.__image = image
        self.__features = feature_fn(params, image)

    def build_content(self, feature_map_indices: Union[int, List[int]]):
        list_taken = isinstance(feature_map_indices, list)
        indices = feature_map_indices if list_taken else [feature_map_indices]
        rep = [x.squeeze(0)
               for i, x in enumerate(self.__features) if i in indices]
        return rep if list_taken else rep[0]

    def build_style(self, feature_map_indices: Union[int, List[int]]):
        list_taken = isinstance(feature_map_indices, list)
        indices = feature_map_indices if list_taken else [feature_map_indices]
        rep = [gram_matrix(x)
               for i, x in enumerate(self.__features) if i in indices]
        return rep if list_taken else rep[0]


class LossBuilder:
    """Weighted content+style+TV loss with precomputed targets
    (reference neural_style_transfer.py:66-112)."""

    def __init__(self, content_feature_maps_index: int,
                 style_feature_maps_indices: Sequence[int],
                 target_content_image: torch.Tensor,
                 target_style_image: torch.Tensor,
                 params, content_weight: float, style_weight: float,
                 tv_weight: float, feature_fn=extract_features,
                 noise_power: float = 0.0):
        self.__content_index = content_feature_maps_index
        self.__style_indices = list(style_feature_maps_indices)
        self.__params = params
        self.__feature_fn = feature_fn
        self.__content_weight = content_weight
        self.__style_weight = style_weight
        self.__tv_weight = tv_weight
        self.__noise_power = noise_power

        with torch.no_grad():
            content_rep = RepresentationBuilder(target_content_image, params,
                                                feature_fn)
            style_rep = RepresentationBuilder(target_style_image, params,
                                              feature_fn)
            self.__target_content = content_rep.build_content(
                content_feature_maps_index)
            self.__target_style = style_rep.build_style(self.__style_indices)

    def build(self, optimizing_img: torch.Tensor,
              generator: Optional[torch.Generator] = None):
        """Returns (total, content, style, tv) losses, 0-d tensors.
        generator draws the content-target noise when noise_power > 0 (a
        generator on the image's device seeded with 0 when None)."""
        current = RepresentationBuilder(optimizing_img, self.__params,
                                        self.__feature_fn)
        current_content = current.build_content(self.__content_index)

        target_content = self.__target_content
        if self.__noise_power > 0.0:
            # experimental per-step target noise (reference :91-93)
            if generator is None:
                generator = torch.Generator(
                    device=target_content.device).manual_seed(0)
            noise = torch.randn(target_content.shape, generator=generator,
                                device=target_content.device)
            target_content = target_content + self.__noise_power * torch.clamp(
                0.5 * noise + 0.5, 0.0, 1.0)

        content_loss = torch.mean(
            torch.square(target_content - current_content))

        current_style = current.build_style(self.__style_indices)
        style_loss = 0.0
        for gram_gt, gram_hat in zip(self.__target_style, current_style):
            style_loss = style_loss + torch.mean(
                torch.square(gram_gt[0] - gram_hat[0]))
        style_loss = style_loss / len(self.__target_style)

        tv_loss = total_variation(optimizing_img)
        total = (self.__content_weight * content_loss
                 + self.__style_weight * style_loss
                 + self.__tv_weight * tv_loss)
        return total, content_loss, style_loss, tv_loss
