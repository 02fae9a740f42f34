# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: schedule.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()



DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0eschedule.proto\x12\x07yodatpu"J\n\x06Tensor\x12\r\n\x05dtype\x18\x01 \x01(\t\x12\r\n\x05shape\x18\x02 \x03(\x03\x12\x0c\n\x04data\x18\x03 \x01(\x0c\x12\x14\n\x0csame_as_last\x18\x04 \x01(\x08"\x84\x01\n\x0cNamedTensors\x123\n\x07tensors\x18\x01 \x03(\x0b2".yodatpu.NamedTensors.TensorsEntry\x1a?\n\x0cTensorsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x1e\n\x05value\x18\x02 \x01(\x0b2\x0f.yodatpu.Tensor:\x028\x01"+\n\x0bScorePlugin\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0e\n\x06weight\x18\x02 \x01(\x01"\xf4\x03\n\x0fScheduleRequest\x12\'\n\x08snapshot\x18\x01 \x01(\x0b2\x15.yodatpu.NamedTensors\x12#\n\x04pods\x18\x02 \x01(\x0b2\x15.yodatpu.NamedTensors\x12\x0e\n\x06policy\x18\x03 \x01(\t\x12\x10\n\x08assigner\x18\x04 \x01(\t\x12\x12\n\nnormalizer\x18\x05 \x01(\t\x12\x16\n\x0edecisions_only\x18\x06 \x01(\x08\x12\r\n\x05fused\x18\x07 \x01(\x08\x12\x16\n\x0eaffinity_aware\x18\x08 \x01(\x08\x12\x0c\n\x04soft\x18\t \x01(\x08\x12\x1a\n\x12auction_price_frac\x18\n \x01(\x01\x12\x16\n\x0eauction_rounds\x18\x0b \x01(\x03\x12&\n\x07victims\x18\x0c \x01(\x0b2\x15.yodatpu.NamedTensors\x12\x15\n\rpreempt_k_cap\x18\r \x01(\x03\x12+\n\rscore_plugins\x18\x0e \x03(\x0b2\x14.yodatpu.ScorePlugin\x12\x12\n\nsession_id\x18\x0f \x01(\t\x12-\n\x0esnapshot_delta\x18\x10 \x01(\x0b2\x15.yodatpu.NamedTensors\x12\x16\n\x0eresident_epoch\x18\x11 \x01(\x04\x12\x15\n\rresident_full\x18\x12 \x01(\x08"N\n\rScheduleReply\x12%\n\x06result\x18\x01 \x01(\x0b2\x15.yodatpu.NamedTensors\x12\x16\n\x0eengine_seconds\x18\x02 \x01(\x01"\x0f\n\rHealthRequest"\x81\x02\n\x0bHealthReply\x12\x0e\n\x06status\x18\x01 \x01(\t\x12\x14\n\x0cdevice_count\x18\x02 \x01(\x05\x12\x10\n\x08platform\x18\x03 \x01(\t\x12\x15\n\rcycles_served\x18\x04 \x01(\x04\x12\x13\n\x0bfield_cache\x18\x05 \x01(\x08\x12\x16\n\x0eresident_state\x18\x06 \x01(\x08\x12)\n\x10windows_resident\x18\x07 \x01(\x08R\x0fwindowsResident\x12\'\n\x0fgang_scheduling\x18\x08 \x01(\x08R\x0egangScheduling\x12"\n\rfused_min_max\x18\t \x01(\x08R\x0bfusedMinMax2\x85\x02\n\x06Engine\x12A\n\rScheduleBatch\x12\x18.yodatpu.ScheduleRequest\x1a\x16.yodatpu.ScheduleReply\x12C\n\x0fScheduleWindows\x12\x18.yodatpu.ScheduleRequest\x1a\x16.yodatpu.ScheduleReply\x12;\n\x07Preempt\x12\x18.yodatpu.ScheduleRequest\x1a\x16.yodatpu.ScheduleReply\x126\n\x06Health\x12\x16.yodatpu.HealthRequest\x1a\x14.yodatpu.HealthReplyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'schedule_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _NAMEDTENSORS_TENSORSENTRY._options = None
  _NAMEDTENSORS_TENSORSENTRY._serialized_options = b'8\001'
  _TENSOR._serialized_start=27
  _TENSOR._serialized_end=101
  _NAMEDTENSORS._serialized_start=104
  _NAMEDTENSORS._serialized_end=236
  _NAMEDTENSORS_TENSORSENTRY._serialized_start=173
  _NAMEDTENSORS_TENSORSENTRY._serialized_end=236
  _SCOREPLUGIN._serialized_start=238
  _SCOREPLUGIN._serialized_end=281
  _SCHEDULEREQUEST._serialized_start=284
  _SCHEDULEREQUEST._serialized_end=784
  _SCHEDULEREPLY._serialized_start=786
  _SCHEDULEREPLY._serialized_end=864
  _HEALTHREQUEST._serialized_start=866
  _HEALTHREQUEST._serialized_end=881
  _HEALTHREPLY._serialized_start=884
  _HEALTHREPLY._serialized_end=1141
  _ENGINE._serialized_start=1144
  _ENGINE._serialized_end=1405
# @@protoc_insertion_point(module_scope)
