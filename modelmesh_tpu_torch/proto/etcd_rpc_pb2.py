# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: etcd_rpc.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0e\x65tcd_rpc.proto\x12\x0c\x65tcdserverpb\"\\\n\x0eResponseHeader\x12\x12\n\ncluster_id\x18\x01 \x01(\x04\x12\x11\n\tmember_id\x18\x02 \x01(\x04\x12\x10\n\x08revision\x18\x03 \x01(\x03\x12\x11\n\traft_term\x18\x04 \x01(\x04\"y\n\x0cMvccKeyValue\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\x17\n\x0f\x63reate_revision\x18\x02 \x01(\x03\x12\x14\n\x0cmod_revision\x18\x03 \x01(\x03\x12\x0f\n\x07version\x18\x04 \x01(\x03\x12\r\n\x05value\x18\x05 \x01(\x0c\x12\r\n\x05lease\x18\x06 \x01(\x03\"v\n\x0cRangeRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\x11\n\trange_end\x18\x02 \x01(\x0c\x12\r\n\x05limit\x18\x03 \x01(\x03\x12\x10\n\x08revision\x18\x04 \x01(\x03\x12\x11\n\tkeys_only\x18\x08 \x01(\x08\x12\x12\n\ncount_only\x18\t \x01(\x08\"\x83\x01\n\rRangeResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\x12\'\n\x03kvs\x18\x02 \x03(\x0b\x32\x1a.etcdserverpb.MvccKeyValue\x12\x0c\n\x04more\x18\x03 \x01(\x08\x12\r\n\x05\x63ount\x18\x04 \x01(\x03\"H\n\nPutRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\r\n\x05value\x18\x02 \x01(\x0c\x12\r\n\x05lease\x18\x03 \x01(\x03\x12\x0f\n\x07prev_kv\x18\x04 \x01(\x08\"h\n\x0bPutResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\x12+\n\x07prev_kv\x18\x02 \x01(\x0b\x32\x1a.etcdserverpb.MvccKeyValue\"E\n\x12\x44\x65leteRangeRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\x11\n\trange_end\x18\x02 \x01(\x0c\x12\x0f\n\x07prev_kv\x18\x03 \x01(\x08\"\x82\x01\n\x13\x44\x65leteRangeResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\x12\x0f\n\x07\x64\x65leted\x18\x02 \x01(\x03\x12,\n\x08prev_kvs\x18\x03 \x03(\x0b\x32\x1a.etcdserverpb.MvccKeyValue\"\xcf\x02\n\x07\x43ompare\x12\x33\n\x06result\x18\x01 \x01(\x0e\x32#.etcdserverpb.Compare.CompareResult\x12\x33\n\x06target\x18\x02 \x01(\x0e\x32#.etcdserverpb.Compare.CompareTarget\x12\x0b\n\x03key\x18\x03 \x01(\x0c\x12\x0f\n\x07version\x18\x04 \x01(\x03\x12\x17\n\x0f\x63reate_revision\x18\x05 \x01(\x03\x12\x14\n\x0cmod_revision\x18\x06 \x01(\x03\x12\r\n\x05value\x18\x07 \x01(\x0c\"@\n\rCompareResult\x12\t\n\x05\x45QUAL\x10\x00\x12\x0b\n\x07GREATER\x10\x01\x12\x08\n\x04LESS\x10\x02\x12\r\n\tNOT_EQUAL\x10\x03\"<\n\rCompareTarget\x12\x0b\n\x07VERSION\x10\x00\x12\n\n\x06\x43REATE\x10\x01\x12\x07\n\x03MOD\x10\x02\x12\t\n\x05VALUE\x10\x03\"\xad\x01\n\tRequestOp\x12\x31\n\rrequest_range\x18\x01 \x01(\x0b\x32\x1a.etcdserverpb.RangeRequest\x12-\n\x0brequest_put\x18\x02 \x01(\x0b\x32\x18.etcdserverpb.PutRequest\x12>\n\x14request_delete_range\x18\x03 \x01(\x0b\x32 .etcdserverpb.DeleteRangeRequest\"\xb4\x01\n\nResponseOp\x12\x33\n\x0eresponse_range\x18\x01 \x01(\x0b\x32\x1b.etcdserverpb.RangeResponse\x12/\n\x0cresponse_put\x18\x02 \x01(\x0b\x32\x19.etcdserverpb.PutResponse\x12@\n\x15response_delete_range\x18\x03 \x01(\x0b\x32!.etcdserverpb.DeleteRangeResponse\"\x88\x01\n\nTxnRequest\x12&\n\x07\x63ompare\x18\x01 \x03(\x0b\x32\x15.etcdserverpb.Compare\x12(\n\x07success\x18\x02 \x03(\x0b\x32\x17.etcdserverpb.RequestOp\x12(\n\x07\x66\x61ilure\x18\x03 \x03(\x0b\x32\x17.etcdserverpb.RequestOp\"{\n\x0bTxnResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\x12\x11\n\tsucceeded\x18\x02 \x01(\x08\x12+\n\tresponses\x18\x03 \x03(\x0b\x32\x18.etcdserverpb.ResponseOp\"\xed\x01\n\x12WatchCreateRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\x11\n\trange_end\x18\x02 \x01(\x0c\x12\x16\n\x0estart_revision\x18\x03 \x01(\x03\x12\x17\n\x0fprogress_notify\x18\x04 \x01(\x08\x12<\n\x07\x66ilters\x18\x05 \x03(\x0e\x32+.etcdserverpb.WatchCreateRequest.FilterType\x12\x0f\n\x07prev_kv\x18\x06 \x01(\x08\x12\x10\n\x08\x66ragment\x18\x08 \x01(\x08\"%\n\nFilterType\x12\t\n\x05NOPUT\x10\x00\x12\x0c\n\x08NODELETE\x10\x01\"&\n\x12WatchCancelRequest\x12\x10\n\x08watch_id\x18\x01 \x01(\x03\"\x16\n\x14WatchProgressRequest\"\xc0\x01\n\x0cWatchRequest\x12\x38\n\x0e\x63reate_request\x18\x01 \x01(\x0b\x32 .etcdserverpb.WatchCreateRequest\x12\x38\n\x0e\x63\x61ncel_request\x18\x02 \x01(\x0b\x32 .etcdserverpb.WatchCancelRequest\x12<\n\x10progress_request\x18\x03 \x01(\x0b\x32\".etcdserverpb.WatchProgressRequest\"\xb3\x01\n\tMvccEvent\x12/\n\x04type\x18\x01 \x01(\x0e\x32!.etcdserverpb.MvccEvent.EventType\x12&\n\x02kv\x18\x02 \x01(\x0b\x32\x1a.etcdserverpb.MvccKeyValue\x12+\n\x07prev_kv\x18\x03 \x01(\x0b\x32\x1a.etcdserverpb.MvccKeyValue\" \n\tEventType\x12\x07\n\x03PUT\x10\x00\x12\n\n\x06\x44\x45LETE\x10\x01\"\xc7\x01\n\rWatchResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\x12\x10\n\x08watch_id\x18\x02 \x01(\x03\x12\x0f\n\x07\x63reated\x18\x03 \x01(\x08\x12\x10\n\x08\x63\x61nceled\x18\x04 \x01(\x08\x12\x18\n\x10\x63ompact_revision\x18\x05 \x01(\x03\x12\x10\n\x08\x66ragment\x18\x07 \x01(\x08\x12\'\n\x06\x65vents\x18\x0b \x03(\x0b\x32\x17.etcdserverpb.MvccEvent\"7\n\x11\x43ompactionRequest\x12\x10\n\x08revision\x18\x01 \x01(\x03\x12\x10\n\x08physical\x18\x02 \x01(\x08\"B\n\x12\x43ompactionResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\",\n\x11LeaseGrantRequest\x12\x0b\n\x03TTL\x18\x01 \x01(\x03\x12\n\n\x02ID\x18\x02 \x01(\x03\"[\n\x12LeaseGrantResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\x12\n\n\x02ID\x18\x02 \x01(\x03\x12\x0b\n\x03TTL\x18\x03 \x01(\x03\"#\n\x15LeaseKeepAliveRequest\x12\n\n\x02ID\x18\x01 \x01(\x03\"_\n\x16LeaseKeepAliveResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\x12\n\n\x02ID\x18\x02 \x01(\x03\x12\x0b\n\x03TTL\x18\x03 \x01(\x03\" \n\x12LeaseRevokeRequest\x12\n\n\x02ID\x18\x01 \x01(\x03\"C\n\x13LeaseRevokeResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeaderb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'etcd_rpc_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _RESPONSEHEADER._serialized_start=32
  _RESPONSEHEADER._serialized_end=124
  _MVCCKEYVALUE._serialized_start=126
  _MVCCKEYVALUE._serialized_end=247
  _RANGEREQUEST._serialized_start=249
  _RANGEREQUEST._serialized_end=367
  _RANGERESPONSE._serialized_start=370
  _RANGERESPONSE._serialized_end=501
  _PUTREQUEST._serialized_start=503
  _PUTREQUEST._serialized_end=575
  _PUTRESPONSE._serialized_start=577
  _PUTRESPONSE._serialized_end=681
  _DELETERANGEREQUEST._serialized_start=683
  _DELETERANGEREQUEST._serialized_end=752
  _DELETERANGERESPONSE._serialized_start=755
  _DELETERANGERESPONSE._serialized_end=885
  _COMPARE._serialized_start=888
  _COMPARE._serialized_end=1223
  _COMPARE_COMPARERESULT._serialized_start=1097
  _COMPARE_COMPARERESULT._serialized_end=1161
  _COMPARE_COMPARETARGET._serialized_start=1163
  _COMPARE_COMPARETARGET._serialized_end=1223
  _REQUESTOP._serialized_start=1226
  _REQUESTOP._serialized_end=1399
  _RESPONSEOP._serialized_start=1402
  _RESPONSEOP._serialized_end=1582
  _TXNREQUEST._serialized_start=1585
  _TXNREQUEST._serialized_end=1721
  _TXNRESPONSE._serialized_start=1723
  _TXNRESPONSE._serialized_end=1846
  _WATCHCREATEREQUEST._serialized_start=1849
  _WATCHCREATEREQUEST._serialized_end=2086
  _WATCHCREATEREQUEST_FILTERTYPE._serialized_start=2049
  _WATCHCREATEREQUEST_FILTERTYPE._serialized_end=2086
  _WATCHCANCELREQUEST._serialized_start=2088
  _WATCHCANCELREQUEST._serialized_end=2126
  _WATCHPROGRESSREQUEST._serialized_start=2128
  _WATCHPROGRESSREQUEST._serialized_end=2150
  _WATCHREQUEST._serialized_start=2153
  _WATCHREQUEST._serialized_end=2345
  _MVCCEVENT._serialized_start=2348
  _MVCCEVENT._serialized_end=2527
  _MVCCEVENT_EVENTTYPE._serialized_start=2495
  _MVCCEVENT_EVENTTYPE._serialized_end=2527
  _WATCHRESPONSE._serialized_start=2530
  _WATCHRESPONSE._serialized_end=2729
  _COMPACTIONREQUEST._serialized_start=2731
  _COMPACTIONREQUEST._serialized_end=2786
  _COMPACTIONRESPONSE._serialized_start=2788
  _COMPACTIONRESPONSE._serialized_end=2854
  _LEASEGRANTREQUEST._serialized_start=2856
  _LEASEGRANTREQUEST._serialized_end=2900
  _LEASEGRANTRESPONSE._serialized_start=2902
  _LEASEGRANTRESPONSE._serialized_end=2993
  _LEASEKEEPALIVEREQUEST._serialized_start=2995
  _LEASEKEEPALIVEREQUEST._serialized_end=3030
  _LEASEKEEPALIVERESPONSE._serialized_start=3032
  _LEASEKEEPALIVERESPONSE._serialized_end=3127
  _LEASEREVOKEREQUEST._serialized_start=3129
  _LEASEREVOKEREQUEST._serialized_end=3161
  _LEASEREVOKERESPONSE._serialized_start=3163
  _LEASEREVOKERESPONSE._serialized_end=3230
# @@protoc_insertion_point(module_scope)
