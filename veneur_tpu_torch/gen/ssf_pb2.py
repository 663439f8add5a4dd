# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: ssf.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tssf.proto\x12\x05ssfpb\"\xec\x03\n\tSSFSample\x12\'\n\x06metric\x18\x01 \x01(\x0e\x32\x17.ssfpb.SSFSample.Metric\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\r\n\x05value\x18\x03 \x01(\x02\x12\x11\n\ttimestamp\x18\x04 \x01(\x03\x12\x0f\n\x07message\x18\x05 \x01(\t\x12\'\n\x06status\x18\x06 \x01(\x0e\x32\x17.ssfpb.SSFSample.Status\x12\x13\n\x0bsample_rate\x18\x07 \x01(\x02\x12(\n\x04tags\x18\x08 \x03(\x0b\x32\x1a.ssfpb.SSFSample.TagsEntry\x12\x0c\n\x04unit\x18\t \x01(\t\x12%\n\x05scope\x18\n \x01(\x0e\x32\x16.ssfpb.SSFSample.Scope\x1a+\n\tTagsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"D\n\x06Metric\x12\x0b\n\x07\x43OUNTER\x10\x00\x12\t\n\x05GAUGE\x10\x01\x12\r\n\tHISTOGRAM\x10\x02\x12\x07\n\x03SET\x10\x03\x12\n\n\x06STATUS\x10\x04\"8\n\x06Status\x12\x06\n\x02OK\x10\x00\x12\x0b\n\x07WARNING\x10\x01\x12\x0c\n\x08\x43RITICAL\x10\x02\x12\x0b\n\x07UNKNOWN\x10\x03\"+\n\x05Scope\x12\x0b\n\x07\x44\x45\x46\x41ULT\x10\x00\x12\t\n\x05LOCAL\x10\x01\x12\n\n\x06GLOBAL\x10\x02\"\xd8\x02\n\x07SSFSpan\x12\x0f\n\x07version\x18\x01 \x01(\x05\x12\x10\n\x08trace_id\x18\x02 \x01(\x03\x12\n\n\x02id\x18\x03 \x01(\x03\x12\x11\n\tparent_id\x18\x04 \x01(\x03\x12\x17\n\x0fstart_timestamp\x18\x05 \x01(\x03\x12\x15\n\rend_timestamp\x18\x06 \x01(\x03\x12\r\n\x05\x65rror\x18\x07 \x01(\x08\x12\x0f\n\x07service\x18\x08 \x01(\t\x12!\n\x07metrics\x18\n \x03(\x0b\x32\x10.ssfpb.SSFSample\x12&\n\x04tags\x18\x0b \x03(\x0b\x32\x18.ssfpb.SSFSpan.TagsEntry\x12\x11\n\tindicator\x18\x0c \x01(\x08\x12\x0c\n\x04name\x18\r \x01(\t\x12\x1c\n\x14root_start_timestamp\x18\x0e \x01(\x03\x1a+\n\tTagsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01J\x04\x08\t\x10\nb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'ssf_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SSFSAMPLE_TAGSENTRY._options = None
  _SSFSAMPLE_TAGSENTRY._serialized_options = b'8\001'
  _SSFSPAN_TAGSENTRY._options = None
  _SSFSPAN_TAGSENTRY._serialized_options = b'8\001'
  _SSFSAMPLE._serialized_start=21
  _SSFSAMPLE._serialized_end=513
  _SSFSAMPLE_TAGSENTRY._serialized_start=297
  _SSFSAMPLE_TAGSENTRY._serialized_end=340
  _SSFSAMPLE_METRIC._serialized_start=342
  _SSFSAMPLE_METRIC._serialized_end=410
  _SSFSAMPLE_STATUS._serialized_start=412
  _SSFSAMPLE_STATUS._serialized_end=468
  _SSFSAMPLE_SCOPE._serialized_start=470
  _SSFSAMPLE_SCOPE._serialized_end=513
  _SSFSPAN._serialized_start=516
  _SSFSPAN._serialized_end=860
  _SSFSPAN_TAGSENTRY._serialized_start=297
  _SSFSPAN_TAGSENTRY._serialized_end=340
# @@protoc_insertion_point(module_scope)
