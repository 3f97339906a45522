"""floor: high-level object read/write over the row path (floor.Writer,
floor.Reader, schema_from_dataclass, the Marshal/Unmarshal object model)
and Time, the nanosecond time of day."""

from .api import Reader, Writer  # noqa: F401
from .autoschema import AutoSchemaError, schema_from_dataclass  # noqa: F401
from .interfaces import (  # noqa: F401
    FieldNotPresentError,
    MarshalList,
    MarshalMap,
    MarshalObject,
    UnmarshalList,
    UnmarshalMap,
    UnmarshalObject,
)
from .time import Time  # noqa: F401
