"""Dataset conversion tools: the COCO caption pipeline and its Vocab
(the port's part of the JAX package's `tools/`)."""

from .conversions import (coco_to_image_caption, embedding_to_caption,
                          image_caption_to_embedding)
from .vocab import Vocab
