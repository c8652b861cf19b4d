from masters_thesis_tpu_torch.decode.beam import make_beam_decoder
from masters_thesis_tpu_torch.decode.greedy import make_greedy_decoder
from masters_thesis_tpu_torch.decode.sampling import make_sampling_decoder

__all__ = ["make_beam_decoder", "make_greedy_decoder",
           "make_sampling_decoder"]
