"""Parquet file-format metadata model (parquet-format 2.9.0).

Declarative equivalents of the structs the reference uses from its 12.5k-line
generated Thrift model (reference: parquet/parquet.go — Type :27, Encoding :344,
CompressionCodec :444, SchemaElement :3663, DataPageHeader :4314). Field ids and
types follow the public parquet-format thrift IDL.
"""

from __future__ import annotations

import enum

from .thrift import (
    T_BOOL,
    T_BYTE,
    T_I16,
    T_I32,
    T_I64,
    T_BINARY,
    T_STRING,
    T_LIST,
    T_STRUCT,
    TStruct,
)


class Type(enum.IntEnum):
    """Physical types (parquet.thrift Type)."""

    BOOLEAN = 0
    INT32 = 1
    INT64 = 2
    INT96 = 3
    FLOAT = 4
    DOUBLE = 5
    BYTE_ARRAY = 6
    FIXED_LEN_BYTE_ARRAY = 7


class ConvertedType(enum.IntEnum):
    UTF8 = 0
    MAP = 1
    MAP_KEY_VALUE = 2
    LIST = 3
    ENUM = 4
    DECIMAL = 5
    DATE = 6
    TIME_MILLIS = 7
    TIME_MICROS = 8
    TIMESTAMP_MILLIS = 9
    TIMESTAMP_MICROS = 10
    UINT_8 = 11
    UINT_16 = 12
    UINT_32 = 13
    UINT_64 = 14
    INT_8 = 15
    INT_16 = 16
    INT_32 = 17
    INT_64 = 18
    JSON = 19
    BSON = 20
    INTERVAL = 21


class FieldRepetitionType(enum.IntEnum):
    REQUIRED = 0
    OPTIONAL = 1
    REPEATED = 2


class Encoding(enum.IntEnum):
    PLAIN = 0
    PLAIN_DICTIONARY = 2
    RLE = 3
    BIT_PACKED = 4
    DELTA_BINARY_PACKED = 5
    DELTA_LENGTH_BYTE_ARRAY = 6
    DELTA_BYTE_ARRAY = 7
    RLE_DICTIONARY = 8
    BYTE_STREAM_SPLIT = 9


class CompressionCodec(enum.IntEnum):
    UNCOMPRESSED = 0
    SNAPPY = 1
    GZIP = 2
    LZO = 3
    BROTLI = 4
    LZ4 = 5
    ZSTD = 6
    LZ4_RAW = 7


class PageType(enum.IntEnum):
    DATA_PAGE = 0
    INDEX_PAGE = 1
    DICTIONARY_PAGE = 2
    DATA_PAGE_V2 = 3


# -- logical types (union of empty/parameterized structs) ----------------------


class StringType(TStruct):
    FIELDS = {}


class MapType(TStruct):
    FIELDS = {}


class ListType(TStruct):
    FIELDS = {}


class EnumType(TStruct):
    FIELDS = {}


class DateType(TStruct):
    FIELDS = {}


class NullType(TStruct):
    FIELDS = {}


class JsonType(TStruct):
    FIELDS = {}


class BsonType(TStruct):
    FIELDS = {}


class UUIDType(TStruct):
    FIELDS = {}


class Float16Type(TStruct):
    FIELDS = {}


class DecimalType(TStruct):
    FIELDS = {
        1: ("scale", T_I32, None),
        2: ("precision", T_I32, None),
    }


class MilliSeconds(TStruct):
    FIELDS = {}


class MicroSeconds(TStruct):
    FIELDS = {}


class NanoSeconds(TStruct):
    FIELDS = {}


class TimeUnit(TStruct):
    """Union MILLIS / MICROS / NANOS."""

    FIELDS = {
        1: ("MILLIS", T_STRUCT, MilliSeconds),
        2: ("MICROS", T_STRUCT, MicroSeconds),
        3: ("NANOS", T_STRUCT, NanoSeconds),
    }

    def unit_name(self) -> str:
        if self.MILLIS is not None:
            return "MILLIS"
        if self.MICROS is not None:
            return "MICROS"
        if self.NANOS is not None:
            return "NANOS"
        return "?"

    @classmethod
    def millis(cls):
        return cls(MILLIS=MilliSeconds())

    @classmethod
    def micros(cls):
        return cls(MICROS=MicroSeconds())

    @classmethod
    def nanos(cls):
        return cls(NANOS=NanoSeconds())


class TimestampType(TStruct):
    FIELDS = {
        1: ("isAdjustedToUTC", T_BOOL, None),
        2: ("unit", T_STRUCT, TimeUnit),
    }


class TimeType(TStruct):
    FIELDS = {
        1: ("isAdjustedToUTC", T_BOOL, None),
        2: ("unit", T_STRUCT, TimeUnit),
    }


class IntType(TStruct):
    FIELDS = {
        1: ("bitWidth", T_BYTE, None),
        2: ("isSigned", T_BOOL, None),
    }


class LogicalType(TStruct):
    """Union over all logical type annotations (parquet.thrift LogicalType)."""

    FIELDS = {
        1: ("STRING", T_STRUCT, StringType),
        2: ("MAP", T_STRUCT, MapType),
        3: ("LIST", T_STRUCT, ListType),
        4: ("ENUM", T_STRUCT, EnumType),
        5: ("DECIMAL", T_STRUCT, DecimalType),
        6: ("DATE", T_STRUCT, DateType),
        7: ("TIME", T_STRUCT, TimeType),
        8: ("TIMESTAMP", T_STRUCT, TimestampType),
        # 9 reserved (interval)
        10: ("INTEGER", T_STRUCT, IntType),
        11: ("UNKNOWN", T_STRUCT, NullType),
        12: ("JSON", T_STRUCT, JsonType),
        13: ("BSON", T_STRUCT, BsonType),
        14: ("UUID", T_STRUCT, UUIDType),
        15: ("FLOAT16", T_STRUCT, Float16Type),
    }

    def which(self) -> str | None:
        for _fid, (name, _ft, _spec) in self.FIELDS.items():
            if getattr(self, name) is not None:
                return name
        return None


# -- schema / statistics -------------------------------------------------------


class SchemaElement(TStruct):
    FIELDS = {
        1: ("type", T_I32, None),
        2: ("type_length", T_I32, None),
        3: ("repetition_type", T_I32, None),
        4: ("name", T_STRING, None),
        5: ("num_children", T_I32, None),
        6: ("converted_type", T_I32, None),
        7: ("scale", T_I32, None),
        8: ("precision", T_I32, None),
        9: ("field_id", T_I32, None),
        10: ("logicalType", T_STRUCT, LogicalType),
    }


class Statistics(TStruct):
    FIELDS = {
        1: ("max", T_BINARY, None),
        2: ("min", T_BINARY, None),
        3: ("null_count", T_I64, None),
        4: ("distinct_count", T_I64, None),
        5: ("max_value", T_BINARY, None),
        6: ("min_value", T_BINARY, None),
        7: ("is_max_value_exact", T_BOOL, None),
        8: ("is_min_value_exact", T_BOOL, None),
    }


class SplitBlockAlgorithm(TStruct):
    FIELDS = {}


class BloomFilterAlgorithm(TStruct):
    FIELDS = {1: ("BLOCK", T_STRUCT, SplitBlockAlgorithm)}


class XxHash(TStruct):
    FIELDS = {}


class BloomFilterHash(TStruct):
    FIELDS = {1: ("XXHASH", T_STRUCT, XxHash)}


class BloomFilterUncompressed(TStruct):  # thrift name: Uncompressed
    FIELDS = {}


class BloomFilterCompression(TStruct):
    FIELDS = {1: ("UNCOMPRESSED", T_STRUCT, BloomFilterUncompressed)}


class BloomFilterHeader(TStruct):
    """Precedes the split-block bloom bitset at
    ColumnMetaData.bloom_filter_offset (parquet.thrift)."""

    FIELDS = {
        1: ("numBytes", T_I32, None),
        2: ("algorithm", T_STRUCT, BloomFilterAlgorithm),
        3: ("hash", T_STRUCT, BloomFilterHash),
        4: ("compression", T_STRUCT, BloomFilterCompression),
    }


class BoundaryOrder(enum.IntEnum):
    """Ordering of min/max values across a ColumnIndex (parquet.thrift)."""

    UNORDERED = 0
    ASCENDING = 1
    DESCENDING = 2


class PageLocation(TStruct):
    FIELDS = {
        1: ("offset", T_I64, None),
        2: ("compressed_page_size", T_I32, None),
        3: ("first_row_index", T_I64, None),
    }


class OffsetIndex(TStruct):
    """Per-page physical locations of one column chunk (the page index's
    row-range half; written after the row groups, referenced from
    ColumnChunk.offset_index_offset/_length)."""

    FIELDS = {
        1: ("page_locations", T_LIST, (T_STRUCT, PageLocation)),
        2: ("unencoded_byte_array_data_bytes", T_LIST, (T_I64, None)),
    }


class ColumnIndex(TStruct):
    """Per-page min/max/null statistics of one column chunk (the page
    index's pruning half; ColumnChunk.column_index_offset/_length)."""

    FIELDS = {
        1: ("null_pages", T_LIST, (T_BOOL, None)),
        2: ("min_values", T_LIST, (T_BINARY, None)),
        3: ("max_values", T_LIST, (T_BINARY, None)),
        4: ("boundary_order", T_I32, None),
        5: ("null_counts", T_LIST, (T_I64, None)),
        6: ("repetition_level_histograms", T_LIST, (T_I64, None)),
        7: ("definition_level_histograms", T_LIST, (T_I64, None)),
    }


class KeyValue(TStruct):
    FIELDS = {
        1: ("key", T_STRING, None),
        2: ("value", T_STRING, None),
    }


class SortingColumn(TStruct):
    FIELDS = {
        1: ("column_idx", T_I32, None),
        2: ("descending", T_BOOL, None),
        3: ("nulls_first", T_BOOL, None),
    }


class PageEncodingStats(TStruct):
    FIELDS = {
        1: ("page_type", T_I32, None),
        2: ("encoding", T_I32, None),
        3: ("count", T_I32, None),
    }


# -- column / row-group metadata -----------------------------------------------


class ColumnMetaData(TStruct):
    FIELDS = {
        1: ("type", T_I32, None),
        2: ("encodings", T_LIST, (T_I32, None)),
        3: ("path_in_schema", T_LIST, (T_STRING, None)),
        4: ("codec", T_I32, None),
        5: ("num_values", T_I64, None),
        6: ("total_uncompressed_size", T_I64, None),
        7: ("total_compressed_size", T_I64, None),
        8: ("key_value_metadata", T_LIST, (T_STRUCT, KeyValue)),
        9: ("data_page_offset", T_I64, None),
        10: ("index_page_offset", T_I64, None),
        11: ("dictionary_page_offset", T_I64, None),
        12: ("statistics", T_STRUCT, Statistics),
        13: ("encoding_stats", T_LIST, (T_STRUCT, PageEncodingStats)),
        14: ("bloom_filter_offset", T_I64, None),
        15: ("bloom_filter_length", T_I32, None),
    }


class ColumnChunk(TStruct):
    FIELDS = {
        1: ("file_path", T_STRING, None),
        2: ("file_offset", T_I64, None),
        3: ("meta_data", T_STRUCT, ColumnMetaData),
        4: ("offset_index_offset", T_I64, None),
        5: ("offset_index_length", T_I32, None),
        6: ("column_index_offset", T_I64, None),
        7: ("column_index_length", T_I32, None),
    }


class RowGroup(TStruct):
    FIELDS = {
        1: ("columns", T_LIST, (T_STRUCT, ColumnChunk)),
        2: ("total_byte_size", T_I64, None),
        3: ("num_rows", T_I64, None),
        4: ("sorting_columns", T_LIST, (T_STRUCT, SortingColumn)),
        5: ("file_offset", T_I64, None),
        6: ("total_compressed_size", T_I64, None),
        7: ("ordinal", T_I16, None),
    }


class TypeDefinedOrder(TStruct):
    FIELDS = {}


class ColumnOrder(TStruct):
    FIELDS = {
        1: ("TYPE_ORDER", T_STRUCT, TypeDefinedOrder),
    }


class FileMetaData(TStruct):
    FIELDS = {
        1: ("version", T_I32, None),
        2: ("schema", T_LIST, (T_STRUCT, SchemaElement)),
        3: ("num_rows", T_I64, None),
        4: ("row_groups", T_LIST, (T_STRUCT, RowGroup)),
        5: ("key_value_metadata", T_LIST, (T_STRUCT, KeyValue)),
        6: ("created_by", T_STRING, None),
        7: ("column_orders", T_LIST, (T_STRUCT, ColumnOrder)),
    }


# -- page headers --------------------------------------------------------------


class DataPageHeader(TStruct):
    FIELDS = {
        1: ("num_values", T_I32, None),
        2: ("encoding", T_I32, None),
        3: ("definition_level_encoding", T_I32, None),
        4: ("repetition_level_encoding", T_I32, None),
        5: ("statistics", T_STRUCT, Statistics),
    }


class IndexPageHeader(TStruct):
    FIELDS = {}


class DictionaryPageHeader(TStruct):
    FIELDS = {
        1: ("num_values", T_I32, None),
        2: ("encoding", T_I32, None),
        3: ("is_sorted", T_BOOL, None),
    }


class DataPageHeaderV2(TStruct):
    FIELDS = {
        1: ("num_values", T_I32, None),
        2: ("num_nulls", T_I32, None),
        3: ("num_rows", T_I32, None),
        4: ("encoding", T_I32, None),
        5: ("definition_levels_byte_length", T_I32, None),
        6: ("repetition_levels_byte_length", T_I32, None),
        7: ("is_compressed", T_BOOL, None),
        8: ("statistics", T_STRUCT, Statistics),
    }


class PageHeader(TStruct):
    FIELDS = {
        1: ("type", T_I32, None),
        2: ("uncompressed_page_size", T_I32, None),
        3: ("compressed_page_size", T_I32, None),
        4: ("crc", T_I32, None),
        5: ("data_page_header", T_STRUCT, DataPageHeader),
        6: ("index_page_header", T_STRUCT, IndexPageHeader),
        7: ("dictionary_page_header", T_STRUCT, DictionaryPageHeader),
        8: ("data_page_header_v2", T_STRUCT, DataPageHeaderV2),
    }
