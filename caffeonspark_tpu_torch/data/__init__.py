from .lmdb_io import LmdbReader, LmdbWriter  # noqa: F401
from .source import (DataSource, ImageRecord, datum_to_record,  # noqa: F401
                     get_source)
from .transformer import Transformer  # noqa: F401
