# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: radar_serving.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x13radar_serving.proto\x12\rradar_serving\"\x98\x01\n\x0bScanRequest\x12\x0c\n\x04\x63ube\x18\x01 \x01(\x0c\x12\r\n\x05\x64type\x18\x02 \x01(\t\x12\r\n\x05shape\x18\x03 \x03(\r\x12\x32\n\x07targets\x18\x04 \x03(\x0b\x32!.radar_serving.ScanRequest.Target\x1a)\n\x06Target\x12\t\n\x01x\x18\x01 \x01(\x02\x12\t\n\x01y\x18\x02 \x01(\x02\x12\t\n\x01z\x18\x03 \x01(\x02\"Z\n\x0eRadarDetection\x12\x14\n\x0ctarget_index\x18\x01 \x01(\x05\x12\r\n\x05label\x18\x02 \x01(\t\x12\r\n\x05proba\x18\x03 \x01(\x02\x12\x14\n\x0c\x63lass_probas\x18\x04 \x03(\x02\"_\n\x10\x43lassifyResponse\x12\x31\n\ndetections\x18\x01 \x03(\x0b\x32\x1d.radar_serving.RadarDetection\x12\x18\n\x10model_latency_ms\x18\x02 \x01(\x02\"i\n\rServingConfig\x12\x12\n\ngrid_shape\x18\x01 \x03(\r\x12\x0f\n\x07\x63lasses\x18\x02 \x03(\t\x12\x11\n\tmin_proba\x18\x03 \x01(\x02\x12\x0c\n\x04mode\x18\x04 \x01(\t\x12\x12\n\ncube_dtype\x18\x05 \x01(\t\"\x07\n\x05\x45mpty\"e\n\x0e\x44\x65tectionEvent\x12\x0b\n\x03seq\x18\x01 \x01(\x04\x12\x14\n\x0ctarget_index\x18\x02 \x01(\x05\x12\r\n\x05label\x18\x03 \x01(\t\x12\r\n\x05proba\x18\x04 \x01(\x02\x12\x12\n\nlatency_ms\x18\x05 \x01(\x02\"\x83\x02\n\x0cServingStats\x12\x19\n\x11\x63lassify_requests\x18\x01 \x01(\x04\x12\x13\n\x0bsubscribers\x18\x02 \x01(\r\x12\x10\n\x08uptime_s\x18\x03 \x01(\x01\x12\x18\n\x10\x65vents_published\x18\x04 \x01(\x04\x12\x16\n\x0eloop_processed\x18\x05 \x01(\x04\x12\x14\n\x0cloop_dropped\x18\x06 \x01(\x04\x12\x1b\n\x13loop_latency_p50_ms\x18\x07 \x01(\x02\x12\x1b\n\x13loop_latency_p95_ms\x18\x08 \x01(\x02\x12\x15\n\rmodel_reloads\x18\t \x01(\r\x12\x18\n\x10\x63lassify_batches\x18\n \x01(\x04\x32\xff\x02\n\x0cRadarServing\x12I\n\x08\x43lassify\x12\x1a.radar_serving.ScanRequest\x1a\x1f.radar_serving.ClassifyResponse\"\x00\x12S\n\x0e\x43lassifyStream\x12\x1a.radar_serving.ScanRequest\x1a\x1f.radar_serving.ClassifyResponse\"\x00(\x01\x30\x01\x12H\n\x10GetServingConfig\x12\x14.radar_serving.Empty\x1a\x1c.radar_serving.ServingConfig\"\x00\x12\x44\n\tSubscribe\x12\x14.radar_serving.Empty\x1a\x1d.radar_serving.DetectionEvent\"\x00\x30\x01\x12?\n\x08GetStats\x12\x14.radar_serving.Empty\x1a\x1b.radar_serving.ServingStats\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'radar_serving_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SCANREQUEST._serialized_start=39
  _SCANREQUEST._serialized_end=191
  _SCANREQUEST_TARGET._serialized_start=150
  _SCANREQUEST_TARGET._serialized_end=191
  _RADARDETECTION._serialized_start=193
  _RADARDETECTION._serialized_end=283
  _CLASSIFYRESPONSE._serialized_start=285
  _CLASSIFYRESPONSE._serialized_end=380
  _SERVINGCONFIG._serialized_start=382
  _SERVINGCONFIG._serialized_end=487
  _EMPTY._serialized_start=489
  _EMPTY._serialized_end=496
  _DETECTIONEVENT._serialized_start=498
  _DETECTIONEVENT._serialized_end=599
  _SERVINGSTATS._serialized_start=602
  _SERVINGSTATS._serialized_end=861
  _RADARSERVING._serialized_start=864
  _RADARSERVING._serialized_end=1247
# @@protoc_insertion_point(module_scope)
