"""Native ONNX interchange for the port: the schema bindings (a
byte-identical copy of the JAX package's generated onnx_pb2.py, from
onnx.proto), the ATen-graph -> ONNX-13 emitter (export.py) and a numpy
executor of the emitted op subset (runner.py). Needs protobuf; no onnx,
onnxruntime or tf2onnx package."""
