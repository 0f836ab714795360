# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: mesh_runtime.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x12mesh_runtime.proto\x12\rmmtpu.runtime\"F\n\tModelInfo\x12\x12\n\nmodel_type\x18\x01 \x01(\t\x12\x12\n\nmodel_path\x18\x02 \x01(\t\x12\x11\n\tmodel_key\x18\x03 \x01(\t\"L\n\x10LoadModelRequest\x12\x10\n\x08model_id\x18\x01 \x01(\t\x12&\n\x04info\x18\x02 \x01(\x0b\x32\x18.mmtpu.runtime.ModelInfo\"@\n\x11LoadModelResponse\x12\x12\n\nsize_bytes\x18\x01 \x01(\x04\x12\x17\n\x0fmax_concurrency\x18\x02 \x01(\r\"&\n\x12UnloadModelRequest\x12\x10\n\x08model_id\x18\x01 \x01(\t\"\x15\n\x13UnloadModelResponse\"S\n\x17PredictModelSizeRequest\x12\x10\n\x08model_id\x18\x01 \x01(\t\x12&\n\x04info\x18\x02 \x01(\x0b\x32\x18.mmtpu.runtime.ModelInfo\"$\n\x10ModelSizeRequest\x12\x10\n\x08model_id\x18\x01 \x01(\t\"\'\n\x11ModelSizeResponse\x12\x12\n\nsize_bytes\x18\x01 \x01(\x04\"\x16\n\x14RuntimeStatusRequest\"\xc8\x02\n\x15RuntimeStatusResponse\x12;\n\x06status\x18\x01 \x01(\x0e\x32+.mmtpu.runtime.RuntimeStatusResponse.Status\x12\x16\n\x0e\x63\x61pacity_bytes\x18\x02 \x01(\x04\x12\x18\n\x10load_concurrency\x18\x03 \x01(\r\x12\x17\n\x0fload_timeout_ms\x18\x04 \x01(\r\x12 \n\x18\x64\x65\x66\x61ult_model_size_bytes\x18\x05 \x01(\x04\x12\x1f\n\x17limit_model_concurrency\x18\x06 \x01(\x08\x12\x1b\n\x13\x64\x65vice_memory_bytes\x18\x07 \x01(\x04\x12\x17\n\x0fruntime_version\x18\x08 \x01(\t\".\n\x06Status\x12\x0c\n\x08STARTING\x10\x00\x12\t\n\x05READY\x10\x01\x12\x0b\n\x07\x46\x41ILING\x10\x02\x32\xbe\x03\n\x0cModelRuntime\x12N\n\tLoadModel\x12\x1f.mmtpu.runtime.LoadModelRequest\x1a .mmtpu.runtime.LoadModelResponse\x12T\n\x0bUnloadModel\x12!.mmtpu.runtime.UnloadModelRequest\x1a\".mmtpu.runtime.UnloadModelResponse\x12\\\n\x10PredictModelSize\x12&.mmtpu.runtime.PredictModelSizeRequest\x1a .mmtpu.runtime.ModelSizeResponse\x12N\n\tModelSize\x12\x1f.mmtpu.runtime.ModelSizeRequest\x1a .mmtpu.runtime.ModelSizeResponse\x12Z\n\rRuntimeStatus\x12#.mmtpu.runtime.RuntimeStatusRequest\x1a$.mmtpu.runtime.RuntimeStatusResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'mesh_runtime_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _MODELINFO._serialized_start=37
  _MODELINFO._serialized_end=107
  _LOADMODELREQUEST._serialized_start=109
  _LOADMODELREQUEST._serialized_end=185
  _LOADMODELRESPONSE._serialized_start=187
  _LOADMODELRESPONSE._serialized_end=251
  _UNLOADMODELREQUEST._serialized_start=253
  _UNLOADMODELREQUEST._serialized_end=291
  _UNLOADMODELRESPONSE._serialized_start=293
  _UNLOADMODELRESPONSE._serialized_end=314
  _PREDICTMODELSIZEREQUEST._serialized_start=316
  _PREDICTMODELSIZEREQUEST._serialized_end=399
  _MODELSIZEREQUEST._serialized_start=401
  _MODELSIZEREQUEST._serialized_end=437
  _MODELSIZERESPONSE._serialized_start=439
  _MODELSIZERESPONSE._serialized_end=478
  _RUNTIMESTATUSREQUEST._serialized_start=480
  _RUNTIMESTATUSREQUEST._serialized_end=502
  _RUNTIMESTATUSRESPONSE._serialized_start=505
  _RUNTIMESTATUSRESPONSE._serialized_end=833
  _RUNTIMESTATUSRESPONSE_STATUS._serialized_start=787
  _RUNTIMESTATUSRESPONSE_STATUS._serialized_end=833
  _MODELRUNTIME._serialized_start=836
  _MODELRUNTIME._serialized_end=1282
# @@protoc_insertion_point(module_scope)
