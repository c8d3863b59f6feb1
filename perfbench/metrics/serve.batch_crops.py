"""crops: the mean number of crops a call of the microbatcher's batch_fn
(one ``engine.ocr_page``) carried in the window."""


def read(run):
    batches = run.outcome.batches
    if not batches:
        return None
    return sum(len(ks) for _, _, ks in batches) / len(batches)
