# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: detection_server.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x16\x64\x65tection_server.proto\x12\x10\x64\x65tection_server\"\x90\x02\n\x0e\x44\x65tectedObject\x12\r\n\x05label\x18\x01 \x01(\t\x12\r\n\x05score\x18\x02 \x01(\x02\x12\x0c\n\x04\x61rea\x18\x03 \x01(\x02\x12;\n\x08\x63\x65ntroid\x18\x04 \x01(\x0b\x32).detection_server.DetectedObject.Centroid\x12\x33\n\x04\x62\x62ox\x18\x05 \x01(\x0b\x32%.detection_server.DetectedObject.BBox\x1a \n\x08\x43\x65ntroid\x12\t\n\x01x\x18\x01 \x01(\x02\x12\t\n\x01y\x18\x02 \x01(\x02\x1a>\n\x04\x42\x42ox\x12\x0c\n\x04xmin\x18\x01 \x01(\x02\x12\x0c\n\x04ymin\x18\x02 \x01(\x02\x12\x0c\n\x04xmax\x18\x03 \x01(\x02\x12\x0c\n\x04ymax\x18\x04 \x01(\x02\"D\n\x12\x44\x65tectedObjectData\x12.\n\x04\x64\x61ta\x18\x01 \x03(\x0b\x32 .detection_server.DetectedObject\"1\n\x10\x43\x61meraResolution\x12\r\n\x05width\x18\x01 \x01(\x05\x12\x0e\n\x06height\x18\x02 \x01(\x05\"K\n\x19\x43\x61meraIntrinsicParameters\x12\n\n\x02\x66x\x18\x01 \x01(\x02\x12\n\n\x02\x66y\x18\x02 \x01(\x02\x12\n\n\x02\x63x\x18\x03 \x01(\x02\x12\n\n\x02\x63y\x18\x04 \x01(\x02\"\x07\n\x05\x45mpty\"\x1f\n\rDesiredLabels\x12\x0e\n\x06labels\x18\x01 \x03(\t2\xae\x02\n\x0f\x44\x65tectionServer\x12]\n\x12GetDetectedObjects\x12\x1f.detection_server.DesiredLabels\x1a$.detection_server.DetectedObjectData\"\x00\x12T\n\x13GetCameraResolution\x12\x17.detection_server.Empty\x1a\".detection_server.CameraResolution\"\x00\x12\x66\n\x1cGetCameraIntrinsicParameters\x12\x17.detection_server.Empty\x1a+.detection_server.CameraIntrinsicParameters\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'detection_server_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _DETECTEDOBJECT._serialized_start=45
  _DETECTEDOBJECT._serialized_end=317
  _DETECTEDOBJECT_CENTROID._serialized_start=221
  _DETECTEDOBJECT_CENTROID._serialized_end=253
  _DETECTEDOBJECT_BBOX._serialized_start=255
  _DETECTEDOBJECT_BBOX._serialized_end=317
  _DETECTEDOBJECTDATA._serialized_start=319
  _DETECTEDOBJECTDATA._serialized_end=387
  _CAMERARESOLUTION._serialized_start=389
  _CAMERARESOLUTION._serialized_end=438
  _CAMERAINTRINSICPARAMETERS._serialized_start=440
  _CAMERAINTRINSICPARAMETERS._serialized_end=515
  _EMPTY._serialized_start=517
  _EMPTY._serialized_end=524
  _DESIREDLABELS._serialized_start=526
  _DESIREDLABELS._serialized_end=557
  _DETECTIONSERVER._serialized_start=560
  _DETECTIONSERVER._serialized_end=862
# @@protoc_insertion_point(module_scope)
