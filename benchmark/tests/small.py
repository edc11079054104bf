"""Small sizes of each cell, for runs on the CPU (the plain paths): row
counts, batches and lengths cut (and the query and build widths) so that
a run takes seconds."""

SMALL_TASK = {"max_seq_length": 12, "hidden": 16, "embed_dim": 16, "encoding_dim": 16}

OVERRIDES = {
    "gru-query-bulk": {
        "config": {"serve": {"index_rows": 40960}, "task": SMALL_TASK},
        "traffic": {"batch": 1024, "pool": 2, "check": {"answers": 2, "queries": 16},
                    "query_lengths": {"max": 12}}},
    "gru-query-interactive": {
        "config": {"serve": {"index_rows": 8192}, "task": SMALL_TASK},
        "traffic": {"pool": 8, "check": {"answers": 4}, "query_lengths": {"max": 12},
                    "untraced_seconds": 0.2}},
    # training keeps the configuration's widths, batch and negatives: at
    # width 16, or 16 examples a batch, the bf16 products move the first
    # step's loss past the limit set at the cell's own size
    "qna-train": {
        "config": {"num_targets": 4096, "task": {"max_seq_length": 12}},
        "traffic": {"pool": 2, "chain": 2, "question_lengths": {"max": 10},
                    "passage_lengths": {"max": 12}}},
    "qna-index-build": {
        "config": {"num_targets": 600, "task": SMALL_TASK},
        "traffic": {"check": {"rows": 64}, "passage_lengths": {"max": 12},
                    "untraced_seconds": 0.2}},
}
