"""out_tokens_per_s: every token every batch of the window returned (the
prefill's first and each decode step's), over the harness's clock from the
first batch's submission to the last batch's return: prefill, capture,
decode and the gaps between batches."""


def read(rec):
    return sum(b.tokens.numel() for b in rec.batches) / rec.window_s
