# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: mesh_api.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0emesh_api.proto\x12\tmmtpu.api\"F\n\tModelInfo\x12\x12\n\nmodel_type\x18\x01 \x01(\t\x12\x12\n\nmodel_path\x18\x02 \x01(\t\x12\x11\n\tmodel_key\x18\x03 \x01(\t\"l\n\x14RegisterModelRequest\x12\x10\n\x08model_id\x18\x01 \x01(\t\x12\"\n\x04info\x18\x02 \x01(\x0b\x32\x14.mmtpu.api.ModelInfo\x12\x10\n\x08load_now\x18\x03 \x01(\x08\x12\x0c\n\x04sync\x18\x04 \x01(\x08\"*\n\x16UnregisterModelRequest\x12\x10\n\x08model_id\x18\x01 \x01(\t\"\x19\n\x17UnregisterModelResponse\")\n\x15GetModelStatusRequest\x12\x10\n\x08model_id\x18\x01 \x01(\t\"K\n\x13\x45nsureLoadedRequest\x12\x10\n\x08model_id\x18\x01 \x01(\t\x12\x0c\n\x04sync\x18\x02 \x01(\x08\x12\x14\n\x0clast_used_ms\x18\x03 \x01(\x04\"o\n\x0fModelStatusInfo\x12&\n\x06status\x18\x01 \x01(\x0e\x32\x16.mmtpu.api.ModelStatus\x12\x0e\n\x06\x65rrors\x18\x02 \x03(\t\x12\x10\n\x08model_id\x18\x03 \x01(\t\x12\x12\n\ncopy_count\x18\x04 \x01(\r\"\xd1\x01\n\x10SetVModelRequest\x12\x11\n\tvmodel_id\x18\x01 \x01(\t\x12\x17\n\x0ftarget_model_id\x18\x02 \x01(\t\x12\"\n\x04info\x18\x03 \x01(\x0b\x32\x14.mmtpu.api.ModelInfo\x12\x13\n\x0bupdate_only\x18\x04 \x01(\x08\x12\x1a\n\x12\x61uto_delete_target\x18\x05 \x01(\x08\x12\x10\n\x08load_now\x18\x06 \x01(\x08\x12\x0c\n\x04sync\x18\x07 \x01(\x08\x12\r\n\x05owner\x18\x08 \x01(\t\x12\r\n\x05\x66orce\x18\t \x01(\x08\"7\n\x13\x44\x65leteVModelRequest\x12\x11\n\tvmodel_id\x18\x01 \x01(\t\x12\r\n\x05owner\x18\x02 \x01(\t\"\x16\n\x14\x44\x65leteVModelResponse\"+\n\x16GetVModelStatusRequest\x12\x11\n\tvmodel_id\x18\x01 \x01(\t\"\x83\x02\n\x10VModelStatusInfo\x12\x17\n\x0f\x61\x63tive_model_id\x18\x01 \x01(\t\x12\x17\n\x0ftarget_model_id\x18\x02 \x01(\t\x12@\n\ntransition\x18\x03 \x01(\x0e\x32,.mmtpu.api.VModelStatusInfo.TransitionStatus\x12\x31\n\ractive_status\x18\x04 \x01(\x0b\x32\x1a.mmtpu.api.ModelStatusInfo\x12\r\n\x05owner\x18\x05 \x01(\t\"9\n\x10TransitionStatus\x12\x08\n\x04NONE\x10\x00\x12\x0f\n\x0bIN_PROGRESS\x10\x01\x12\n\n\x06\x46\x41ILED\x10\x02*f\n\x0bModelStatus\x12\r\n\tNOT_FOUND\x10\x00\x12\x0e\n\nNOT_LOADED\x10\x01\x12\x0b\n\x07LOADING\x10\x02\x12\n\n\x06LOADED\x10\x03\x12\x12\n\x0eLOADING_FAILED\x10\x04\x12\x0b\n\x07UNKNOWN\x10\x05\x32\xba\x04\n\tModelMesh\x12L\n\rRegisterModel\x12\x1f.mmtpu.api.RegisterModelRequest\x1a\x1a.mmtpu.api.ModelStatusInfo\x12X\n\x0fUnregisterModel\x12!.mmtpu.api.UnregisterModelRequest\x1a\".mmtpu.api.UnregisterModelResponse\x12N\n\x0eGetModelStatus\x12 .mmtpu.api.GetModelStatusRequest\x1a\x1a.mmtpu.api.ModelStatusInfo\x12J\n\x0c\x45nsureLoaded\x12\x1e.mmtpu.api.EnsureLoadedRequest\x1a\x1a.mmtpu.api.ModelStatusInfo\x12\x45\n\tSetVModel\x12\x1b.mmtpu.api.SetVModelRequest\x1a\x1b.mmtpu.api.VModelStatusInfo\x12O\n\x0c\x44\x65leteVModel\x12\x1e.mmtpu.api.DeleteVModelRequest\x1a\x1f.mmtpu.api.DeleteVModelResponse\x12Q\n\x0fGetVModelStatus\x12!.mmtpu.api.GetVModelStatusRequest\x1a\x1b.mmtpu.api.VModelStatusInfob\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'mesh_api_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _MODELSTATUS._serialized_start=1115
  _MODELSTATUS._serialized_end=1217
  _MODELINFO._serialized_start=29
  _MODELINFO._serialized_end=99
  _REGISTERMODELREQUEST._serialized_start=101
  _REGISTERMODELREQUEST._serialized_end=209
  _UNREGISTERMODELREQUEST._serialized_start=211
  _UNREGISTERMODELREQUEST._serialized_end=253
  _UNREGISTERMODELRESPONSE._serialized_start=255
  _UNREGISTERMODELRESPONSE._serialized_end=280
  _GETMODELSTATUSREQUEST._serialized_start=282
  _GETMODELSTATUSREQUEST._serialized_end=323
  _ENSURELOADEDREQUEST._serialized_start=325
  _ENSURELOADEDREQUEST._serialized_end=400
  _MODELSTATUSINFO._serialized_start=402
  _MODELSTATUSINFO._serialized_end=513
  _SETVMODELREQUEST._serialized_start=516
  _SETVMODELREQUEST._serialized_end=725
  _DELETEVMODELREQUEST._serialized_start=727
  _DELETEVMODELREQUEST._serialized_end=782
  _DELETEVMODELRESPONSE._serialized_start=784
  _DELETEVMODELRESPONSE._serialized_end=806
  _GETVMODELSTATUSREQUEST._serialized_start=808
  _GETVMODELSTATUSREQUEST._serialized_end=851
  _VMODELSTATUSINFO._serialized_start=854
  _VMODELSTATUSINFO._serialized_end=1113
  _VMODELSTATUSINFO_TRANSITIONSTATUS._serialized_start=1056
  _VMODELSTATUSINFO_TRANSITIONSTATUS._serialized_end=1113
  _MODELMESH._serialized_start=1220
  _MODELMESH._serialized_end=1790
# @@protoc_insertion_point(module_scope)
