"""The device-resident beta store, the input pipeline, and the port's
copies of the tokenizer, pairs, splits and synthetic fixtures."""
