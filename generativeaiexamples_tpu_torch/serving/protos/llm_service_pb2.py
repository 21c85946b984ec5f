# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: llm_service.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x11llm_service.proto\x12\x0btpu.serving\"\x84\x02\n\x0fGenerateRequest\x12\x12\n\ntext_input\x18\x01 \x01(\t\x12\x12\n\nmax_tokens\x18\x02 \x01(\r\x12\x13\n\x0btemperature\x18\x03 \x01(\x02\x12\r\n\x05top_k\x18\x04 \x01(\r\x12\r\n\x05top_p\x18\x05 \x01(\x02\x12\x1a\n\x12repetition_penalty\x18\x06 \x01(\x02\x12\x16\n\x0elength_penalty\x18\x07 \x01(\x02\x12\x12\n\nbeam_width\x18\x08 \x01(\r\x12\x13\n\x0brandom_seed\x18\t \x01(\x04\x12\x12\n\nstop_words\x18\n \x03(\t\x12\x11\n\tbad_words\x18\x0b \x03(\t\x12\x12\n\nignore_eos\x18\x0c \x01(\x08\"a\n\x10GenerateResponse\x12\x12\n\nmodel_name\x18\x01 \x01(\t\x12\x13\n\x0btext_output\x18\x02 \x01(\t\x12\r\n\x05\x66inal\x18\x03 \x01(\x08\x12\x15\n\rfinish_reason\x18\x04 \x01(\t\"1\n\x0c\x45mbedRequest\x12\r\n\x05texts\x18\x01 \x03(\t\x12\x12\n\ninput_type\x18\x02 \x01(\t\",\n\rEmbedResponse\x12\x0b\n\x03\x64im\x18\x01 \x01(\r\x12\x0e\n\x06values\x18\x02 \x03(\x02\"\x0f\n\rHealthRequest\"3\n\x0eHealthResponse\x12\r\n\x05ready\x18\x01 \x01(\x08\x12\x12\n\nmodel_name\x18\x02 \x01(\t2\xa9\x02\n\nLLMService\x12\x41\n\x06Health\x12\x1a.tpu.serving.HealthRequest\x1a\x1b.tpu.serving.HealthResponse\x12G\n\x08Generate\x12\x1c.tpu.serving.GenerateRequest\x1a\x1d.tpu.serving.GenerateResponse\x12O\n\x0eGenerateStream\x12\x1c.tpu.serving.GenerateRequest\x1a\x1d.tpu.serving.GenerateResponse0\x01\x12>\n\x05\x45mbed\x12\x19.tpu.serving.EmbedRequest\x1a\x1a.tpu.serving.EmbedResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'llm_service_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _GENERATEREQUEST._serialized_start=35
  _GENERATEREQUEST._serialized_end=295
  _GENERATERESPONSE._serialized_start=297
  _GENERATERESPONSE._serialized_end=394
  _EMBEDREQUEST._serialized_start=396
  _EMBEDREQUEST._serialized_end=445
  _EMBEDRESPONSE._serialized_start=447
  _EMBEDRESPONSE._serialized_end=491
  _HEALTHREQUEST._serialized_start=493
  _HEALTHREQUEST._serialized_end=508
  _HEALTHRESPONSE._serialized_start=510
  _HEALTHRESPONSE._serialized_end=561
  _LLMSERVICE._serialized_start=564
  _LLMSERVICE._serialized_end=861
# @@protoc_insertion_point(module_scope)
