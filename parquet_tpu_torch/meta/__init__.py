from .parquet_types import (  # noqa: F401
    ColumnChunk,
    ColumnMetaData,
    CompressionCodec,
    ConvertedType,
    DataPageHeader,
    DataPageHeaderV2,
    DictionaryPageHeader,
    Encoding,
    FieldRepetitionType,
    FileMetaData,
    KeyValue,
    LogicalType,
    PageHeader,
    PageType,
    RowGroup,
    SchemaElement,
    Statistics,
    Type,
)
from .file_meta import (  # noqa: F401
    MAGIC,
    ParquetFileError,
    read_file_metadata,
    serialize_footer,
)
from .thrift import CompactReader, CompactWriter, ThriftError, TStruct  # noqa: F401
