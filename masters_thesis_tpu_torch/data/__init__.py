"""The beta store (on a device, or on the host over a pack's memmap), the
input pipeline, the pack format, the offline preprocessing
(``data.preprocess``), the NSD stimuli reader, and the port's copies of the
tokenizer, pairs, splits, captions and synthetic fixtures."""
