from slam_process_tpu_torch.io.hexlog import read_hex_log, tokenize_hex, tokenize_hex_reference

__all__ = ["read_hex_log", "tokenize_hex", "tokenize_hex_reference"]
