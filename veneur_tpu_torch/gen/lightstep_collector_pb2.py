# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: lightstep_collector.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import timestamp_pb2 as google_dot_protobuf_dot_timestamp__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x19lightstep_collector.proto\x12\x13lightstep.collector\x1a\x1fgoogle/protobuf/timestamp.proto\"\xa0\x01\n\x0bSpanContext\x12\x10\n\x08trace_id\x18\x01 \x01(\x04\x12\x0f\n\x07span_id\x18\x02 \x01(\x04\x12>\n\x07\x62\x61ggage\x18\x03 \x03(\x0b\x32-.lightstep.collector.SpanContext.BaggageEntry\x1a.\n\x0c\x42\x61ggageEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\x91\x01\n\x08KeyValue\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x16\n\x0cstring_value\x18\x02 \x01(\tH\x00\x12\x13\n\tint_value\x18\x03 \x01(\x03H\x00\x12\x16\n\x0c\x64ouble_value\x18\x04 \x01(\x01H\x00\x12\x14\n\nbool_value\x18\x05 \x01(\x08H\x00\x12\x14\n\njson_value\x18\x06 \x01(\tH\x00\x42\x07\n\x05value\"f\n\x03Log\x12-\n\ttimestamp\x18\x01 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x30\n\tkeyvalues\x18\x02 \x03(\x0b\x32\x1d.lightstep.collector.KeyValue\"\xb6\x01\n\tReference\x12\x41\n\x0crelationship\x18\x01 \x01(\x0e\x32+.lightstep.collector.Reference.Relationship\x12\x36\n\x0cspan_context\x18\x02 \x01(\x0b\x32 .lightstep.collector.SpanContext\".\n\x0cRelationship\x12\x0c\n\x08\x43HILD_OF\x10\x00\x12\x10\n\x0c\x46OLLOWS_FROM\x10\x01\"\xad\x02\n\x04Span\x12\x36\n\x0cspan_context\x18\x01 \x01(\x0b\x32 .lightstep.collector.SpanContext\x12\x16\n\x0eoperation_name\x18\x02 \x01(\t\x12\x32\n\nreferences\x18\x03 \x03(\x0b\x32\x1e.lightstep.collector.Reference\x12\x33\n\x0fstart_timestamp\x18\x04 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x17\n\x0f\x64uration_micros\x18\x05 \x01(\x04\x12+\n\x04tags\x18\x06 \x03(\x0b\x32\x1d.lightstep.collector.KeyValue\x12&\n\x04logs\x18\x07 \x03(\x0b\x32\x18.lightstep.collector.Log\"L\n\x08Reporter\x12\x13\n\x0breporter_id\x18\x01 \x01(\x04\x12+\n\x04tags\x18\x04 \x03(\x0b\x32\x1d.lightstep.collector.KeyValue\"S\n\rMetricsSample\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x13\n\tint_value\x18\x02 \x01(\x03H\x00\x12\x16\n\x0c\x64ouble_value\x18\x03 \x01(\x01H\x00\x42\x07\n\x05value\"\xef\x01\n\x0fInternalMetrics\x12\x33\n\x0fstart_timestamp\x18\x01 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x17\n\x0f\x64uration_micros\x18\x02 \x01(\x04\x12&\n\x04logs\x18\x03 \x03(\x0b\x32\x18.lightstep.collector.Log\x12\x32\n\x06\x63ounts\x18\x04 \x03(\x0b\x32\".lightstep.collector.MetricsSample\x12\x32\n\x06gauges\x18\x05 \x03(\x0b\x32\".lightstep.collector.MetricsSample\"\x1c\n\x04\x41uth\x12\x14\n\x0c\x61\x63\x63\x65ss_token\x18\x01 \x01(\t\"\xf4\x01\n\rReportRequest\x12/\n\x08reporter\x18\x01 \x01(\x0b\x32\x1d.lightstep.collector.Reporter\x12\'\n\x04\x61uth\x18\x02 \x01(\x0b\x32\x19.lightstep.collector.Auth\x12(\n\x05spans\x18\x03 \x03(\x0b\x32\x19.lightstep.collector.Span\x12\x1f\n\x17timestamp_offset_micros\x18\x05 \x01(\x05\x12>\n\x10internal_metrics\x18\x06 \x01(\x0b\x32$.lightstep.collector.InternalMetrics\"\x1a\n\x07\x43ommand\x12\x0f\n\x07\x64isable\x18\x01 \x01(\x08\"\xbf\x01\n\x0eReportResponse\x12.\n\x08\x63ommands\x18\x01 \x03(\x0b\x32\x1c.lightstep.collector.Command\x12\x35\n\x11receive_timestamp\x18\x02 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x36\n\x12transmit_timestamp\x18\x03 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x0e\n\x06\x65rrors\x18\x04 \x03(\tb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'lightstep_collector_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SPANCONTEXT_BAGGAGEENTRY._options = None
  _SPANCONTEXT_BAGGAGEENTRY._serialized_options = b'8\001'
  _SPANCONTEXT._serialized_start=84
  _SPANCONTEXT._serialized_end=244
  _SPANCONTEXT_BAGGAGEENTRY._serialized_start=198
  _SPANCONTEXT_BAGGAGEENTRY._serialized_end=244
  _KEYVALUE._serialized_start=247
  _KEYVALUE._serialized_end=392
  _LOG._serialized_start=394
  _LOG._serialized_end=496
  _REFERENCE._serialized_start=499
  _REFERENCE._serialized_end=681
  _REFERENCE_RELATIONSHIP._serialized_start=635
  _REFERENCE_RELATIONSHIP._serialized_end=681
  _SPAN._serialized_start=684
  _SPAN._serialized_end=985
  _REPORTER._serialized_start=987
  _REPORTER._serialized_end=1063
  _METRICSSAMPLE._serialized_start=1065
  _METRICSSAMPLE._serialized_end=1148
  _INTERNALMETRICS._serialized_start=1151
  _INTERNALMETRICS._serialized_end=1390
  _AUTH._serialized_start=1392
  _AUTH._serialized_end=1420
  _REPORTREQUEST._serialized_start=1423
  _REPORTREQUEST._serialized_end=1667
  _COMMAND._serialized_start=1669
  _COMMAND._serialized_end=1695
  _REPORTRESPONSE._serialized_start=1698
  _REPORTRESPONSE._serialized_end=1889
# @@protoc_insertion_point(module_scope)
