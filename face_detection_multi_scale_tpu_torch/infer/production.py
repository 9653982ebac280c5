"""The JSON tensor contract of the production batch-prediction pipeline.

A copy of part of the JAX package's infer/production.py: `frames_to_json`
and the module constants it uses (`CKPT_VERSION`, `PAD_BBOX`), which
`FaceDetector.export_to_json` needs. The rest of that module (the corpus
loop, frame expansion, skip/resume, the DataFrame and CSV reports) is
not ported yet: ROADMAP queue 1, module 6.

Reference: yolov7_face_multi_scale_dataframe_predict.py:779-837 (the JSON
tensor contract) and its checkpoint version tag.
"""

from __future__ import annotations

from typing import Dict, List, Optional

CKPT_VERSION = "yolo_w6_face_multiscale_v1"
PAD_BBOX = [-1.0, -1.0, -1.0, -1.0]


def frames_to_json(all_frames_data: List[Dict], total_elapsed: float,
                   ckpt_version: str = CKPT_VERSION) -> Optional[Dict]:
    """Per-item Triton-style tensor dict, padded to the max face count
    (yolov7_face_multi_scale_dataframe_predict.py:779-837). Tensor names,
    datatypes, shapes, and padding sentinels match the reference exactly.
    """
    if not all_frames_data:
        return None
    num_frames = len(all_frames_data)
    max_faces = max(f["num_faces"] for f in all_frames_data)

    def pad(frame, key, fill):
        return frame[key] + [fill] * (max_faces - frame["num_faces"])

    tensors = [
        {"name": "yolo-face-bboxes", "datatype": "FP32",
         "shape": [num_frames, max_faces, 4],
         "data": [pad(f, "bboxes", PAD_BBOX) for f in all_frames_data]},
        {"name": "yolo-face-confidence", "datatype": "FP32",
         "shape": [num_frames, max_faces],
         "data": [pad(f, "confidence", -1.0) for f in all_frames_data]},
        {"name": "yolo-face-class_names", "datatype": "BYTES",
         "shape": [num_frames, max_faces],
         "data": [pad(f, "class_names", "unknown")
                  for f in all_frames_data]},
        {"name": "yolo-face-class_indexes", "datatype": "INT32",
         "shape": [num_frames, max_faces],
         "data": [pad(f, "class_indexes", -1) for f in all_frames_data]},
        {"name": "yolo-face-class_groups", "datatype": "BYTES",
         "shape": [num_frames, max_faces],
         "data": [pad(f, "class_groups", "unknown")
                  for f in all_frames_data]},
        {"name": "yolo-face-scale_used", "datatype": "BYTES",
         "shape": [num_frames, max_faces],
         "data": [pad(f, "scale_used", "unknown")
                  for f in all_frames_data]},
        {"name": "yolo-face-ckpt_version", "datatype": "BYTES",
         "shape": [num_frames], "data": [ckpt_version] * num_frames},
        {"name": "yolo-face-infer_time", "datatype": "FP32",
         "shape": [num_frames],
         "data": [f["infer_time"] for f in all_frames_data]},
        {"name": "yolo-face-total_time", "datatype": "FP32",
         "shape": [1], "data": [total_elapsed]},
    ]
    return {"yolo_face_prediction": tensors}
