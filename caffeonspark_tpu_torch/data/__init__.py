from .source import DataSource, ImageRecord, get_source  # noqa: F401
from .transformer import Transformer  # noqa: F401
