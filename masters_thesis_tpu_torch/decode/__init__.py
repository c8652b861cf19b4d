from masters_thesis_tpu_torch.decode.greedy import make_greedy_decoder

__all__ = ["make_greedy_decoder"]
