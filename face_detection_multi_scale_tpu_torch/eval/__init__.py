"""Evaluation: the mAP metrics and the WIDER FACE protocol (numpy)."""
