from .int96 import (  # noqa: F401
    datetime_to_int96,
    int96_to_datetime,
    int96_to_unix_nanos,
    is_after_unix_epoch,
)
