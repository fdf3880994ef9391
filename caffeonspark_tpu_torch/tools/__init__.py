"""Dataset conversion tools (Binary2Sequence/DataFrame, LMDB2*, the COCO
caption pipeline and its Vocab): the port's part of the JAX package's
`tools/`."""

from .conversions import (coco_to_image_caption,  # noqa: F401
                          embedding_to_caption, image_caption_to_embedding)
from .converters import (binary2dataframe, binary2sequence,  # noqa: F401
                         lmdb2dataframe, lmdb2sequence, sequence2lmdb)
from .vocab import Vocab  # noqa: F401
