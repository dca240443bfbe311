"""The ONNX protobuf schema the port reads and writes: a field-number-exact
subset of the official ``onnx.proto`` (package ``ablc_onnx``), the same
serialized file descriptor as the JAX package's generated
``onnx_minimal_pb2``.

The generated module imports ``google.protobuf`` at import time, which the
card's installation lacks. Here the descriptor is plain bytes, and the
message classes are built from it by :func:`messages` on first use, in a
descriptor pool of their own (so they never clash with another module that
registered the same file in protobuf's default pool).
"""

from __future__ import annotations

import functools
import types

#: ``onnx_minimal.proto``'s serialized ``FileDescriptorProto``.
SERIALIZED = (
    b'\n\x12onnx_minimal.proto\x12\tablc_onnx"\xd2\x03\n\x0eAttributeProto'
    b'\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\t\n\x01f\x18\x02 \x01(\x02\x12\t'
    b'\n\x01i\x18\x03 \x01(\x03\x12\t\n\x01s\x18\x04 \x01(\x0c\x12!\n\x01t'
    b'\x18\x05 \x01(\x0b2\x16.ablc_onnx.TensorProto\x12 \n\x01g\x18\x06 \x01('
    b'\x0b2\x15.ablc_onnx.GraphProto\x12\x0e\n\x06floats\x18\x07 \x03(\x02'
    b'\x12\x0c\n\x04ints\x18\x08 \x03(\x03\x12\x0f\n\x07strings\x18\t \x03('
    b"\x0c\x12'\n\x07tensors\x18\n \x03(\x0b2\x16.ablc_onnx.TensorProto\x12"
    b"\x12\n\ndoc_string\x18\r \x01(\t\x125\n\x04type\x18\x14 \x01(\x0e2'.abl"
    b'c_onnx.AttributeProto.AttributeType\x12\x15\n\rref_attr_name\x18\x15 '
    b'\x01(\t"\x91\x01\n\rAttributeType\x12\r\n\tUNDEFINED\x10\x00\x12\t\n'
    b'\x05FLOAT\x10\x01\x12\x07\n\x03INT\x10\x02\x12\n\n\x06STRING\x10\x03'
    b'\x12\n\n\x06TENSOR\x10\x04\x12\t\n\x05GRAPH\x10\x05\x12\n\n\x06FLOATS'
    b'\x10\x06\x12\x08\n\x04INTS\x10\x07\x12\x0b\n\x07STRINGS\x10\x08\x12\x0b'
    b'\n\x07TENSORS\x10\t\x12\n\n\x06GRAPHS\x10\n"V\n\x0eValueInfoProto\x12'
    b'\x0c\n\x04name\x18\x01 \x01(\t\x12"\n\x04type\x18\x02 \x01(\x0b2\x14.ab'
    b'lc_onnx.TypeProto\x12\x12\n\ndoc_string\x18\x03 \x01(\t"\x9b\x01\n\tNod'
    b'eProto\x12\r\n\x05input\x18\x01 \x03(\t\x12\x0e\n\x06output\x18\x02 '
    b'\x03(\t\x12\x0c\n\x04name\x18\x03 \x01(\t\x12\x0f\n\x07op_type\x18\x04 '
    b'\x01(\t\x12,\n\tattribute\x18\x05 \x03(\x0b2\x19.ablc_onnx.AttributePro'
    b'to\x12\x12\n\ndoc_string\x18\x06 \x01(\t\x12\x0e\n\x06domain\x18\x07 '
    b'\x01(\t"\xa2\x02\n\nModelProto\x12\x12\n\nir_version\x18\x01 \x01(\x03'
    b'\x12\x15\n\rproducer_name\x18\x02 \x01(\t\x12\x18\n\x10producer_version'
    b'\x18\x03 \x01(\t\x12\x0e\n\x06domain\x18\x04 \x01(\t\x12\x15\n\rmodel_v'
    b'ersion\x18\x05 \x01(\x03\x12\x12\n\ndoc_string\x18\x06 \x01(\t\x12$\n'
    b'\x05graph\x18\x07 \x01(\x0b2\x15.ablc_onnx.GraphProto\x123\n\x0copset_i'
    b'mport\x18\x08 \x03(\x0b2\x1d.ablc_onnx.OperatorSetIdProto\x129\n\x0emet'
    b'adata_props\x18\x0e \x03(\x0b2!.ablc_onnx.StringStringEntryProto"4\n'
    b'\x16StringStringEntryProto\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05'
    b'value\x18\x02 \x01(\t"\x83\x02\n\nGraphProto\x12"\n\x04node\x18\x01 '
    b'\x03(\x0b2\x14.ablc_onnx.NodeProto\x12\x0c\n\x04name\x18\x02 \x01(\t'
    b'\x12+\n\x0binitializer\x18\x05 \x03(\x0b2\x16.ablc_onnx.TensorProto\x12'
    b'\x12\n\ndoc_string\x18\n \x01(\t\x12(\n\x05input\x18\x0b \x03(\x0b2\x19'
    b'.ablc_onnx.ValueInfoProto\x12)\n\x06output\x18\x0c \x03(\x0b2\x19.ablc_'
    b'onnx.ValueInfoProto\x12-\n\nvalue_info\x18\r \x03(\x0b2\x19.ablc_onnx.V'
    b'alueInfoProto"\xce\x03\n\x0bTensorProto\x12\x0c\n\x04dims\x18\x01 \x03('
    b'\x03\x12\x11\n\tdata_type\x18\x02 \x01(\x05\x12\x16\n\nfloat_data\x18'
    b'\x04 \x03(\x02B\x02\x10\x01\x12\x16\n\nint32_data\x18\x05 \x03(\x05B'
    b'\x02\x10\x01\x12\x13\n\x0bstring_data\x18\x06 \x03(\x0c\x12\x16\n\nint6'
    b'4_data\x18\x07 \x03(\x03B\x02\x10\x01\x12\x0c\n\x04name\x18\x08 \x01(\t'
    b'\x12\x10\n\x08raw_data\x18\t \x01(\x0c\x12\x17\n\x0bdouble_data\x18\n '
    b'\x03(\x01B\x02\x10\x01\x12\x17\n\x0buint64_data\x18\x0b \x03(\x04B\x02'
    b'\x10\x01\x12\x12\n\ndoc_string\x18\x0c \x01(\t"\xda\x01\n\x08DataType'
    b'\x12\r\n\tUNDEFINED\x10\x00\x12\t\n\x05FLOAT\x10\x01\x12\t\n\x05UINT8'
    b'\x10\x02\x12\x08\n\x04INT8\x10\x03\x12\n\n\x06UINT16\x10\x04\x12\t\n'
    b'\x05INT16\x10\x05\x12\t\n\x05INT32\x10\x06\x12\t\n\x05INT64\x10\x07\x12'
    b'\n\n\x06STRING\x10\x08\x12\x08\n\x04BOOL\x10\t\x12\x0b\n\x07FLOAT16\x10'
    b'\n\x12\n\n\x06DOUBLE\x10\x0b\x12\n\n\x06UINT32\x10\x0c\x12\n\n\x06UINT6'
    b'4\x10\r\x12\r\n\tCOMPLEX64\x10\x0e\x12\x0e\n\nCOMPLEX128\x10\x0f\x12'
    b'\x0c\n\x08BFLOAT16\x10\x10"\x9a\x01\n\x10TensorShapeProto\x122\n\x03dim'
    b'\x18\x01 \x03(\x0b2%.ablc_onnx.TensorShapeProto.Dimension\x1aR\n\tDimen'
    b'sion\x12\x13\n\tdim_value\x18\x01 \x01(\x03H\x00\x12\x13\n\tdim_param'
    b'\x18\x02 \x01(\tH\x00\x12\x12\n\ndenotation\x18\x03 \x01(\tB\x07\n\x05v'
    b'alue"\xa5\x01\n\tTypeProto\x122\n\x0btensor_type\x18\x01 \x01(\x0b2\x1b'
    b'.ablc_onnx.TypeProto.TensorH\x00\x12\x12\n\ndenotation\x18\x06 \x01(\t'
    b'\x1aG\n\x06Tensor\x12\x11\n\telem_type\x18\x01 \x01(\x05\x12*\n\x05shap'
    b'e\x18\x02 \x01(\x0b2\x1b.ablc_onnx.TensorShapeProtoB\x07\n\x05value"5\n'
    b'\x12OperatorSetIdProto\x12\x0e\n\x06domain\x18\x01 \x01(\t\x12\x0f\n'
    b'\x07version\x18\x02 \x01(\x03b\x06proto3')


@functools.lru_cache(maxsize=None)
def messages() -> types.SimpleNamespace:
    """The schema's message classes (``ModelProto``, ``GraphProto``,
    ``NodeProto``, ``TensorProto``, ``AttributeProto``, ...), with their
    enums as class attributes (``TensorProto.FLOAT``), built once."""
    from google.protobuf import descriptor_pool, message_factory

    file = descriptor_pool.DescriptorPool().AddSerializedFile(SERIALIZED)
    return types.SimpleNamespace(**{
        name: message_factory.GetMessageClass(desc)
        for name, desc in file.message_types_by_name.items()})
