"""Data sources, transformers and readers (LMDB, LevelDB, SequenceFile,
HDF5, DataFrames, image lists, streaming part directories): the JAX
package's `data/` exports."""

from .lmdb_io import LmdbReader, LmdbWriter  # noqa: F401
from .queue_runner import (DROPPED, FeedQueue, PipelinedFeed,  # noqa: F401
                           TransformerPool, device_prefetch)
from .sequencefile import SequenceFileReader, SequenceFileWriter  # noqa: F401
from .source import (LMDB, STOP_MARK, DataSource,  # noqa: F401
                     ImageDataFrame, ImageRecord, SeqImageDataSource,
                     datum_to_record, get_source, register_source)
# StreamingDirSource (data/streaming.py) is not re-exported, as in the
# JAX package: get_source imports it for source_class "StreamingDir"
from .transformer import AugDraw, Transformer, load_mean_file  # noqa: F401
