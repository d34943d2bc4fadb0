"""Cells at sizes a CPU test run holds: the cell's own files with narrow
widths, small batches and short traffic."""
from perfbench.harness import cell as cell_mod


def cell(name: str, monkeypatch, seed: int = 2 ** 31 + 12345,
         config: str = None):
    """The cell ``name`` (on ``config``'s configuration, if given: the
    configurations whose cells are not in the benchmark) narrowed:
    bilstm-orig 2 x 8 (the program's class
    widths patched through ``monkeypatch``), dprnn-v1 8 / 8, chunks of
    16, one block; 4 rows a batch, K=2, one process; 0.5 s utterances,
    32-frame crops; requests of 0.3-1 s."""
    from danet_tpu_torch.models.encoders import BiLstmEncoder
    c = cell_mod.load(name)
    if config is not None:
        c.config = cell_mod._load_json("configs", config + ".json")
    cfg = dict(c.config)
    if cfg["ENCODER_TYPE"] == "bilstm-orig":
        monkeypatch.setattr(BiLstmEncoder, "HDIM", 8)
        monkeypatch.setattr(BiLstmEncoder, "N_LAYERS", 2)
        cfg["widths"] = {"BILSTM_LAYERS": 2, "BILSTM_HIDDEN": 8}
    else:
        cfg.update(DPRNN_DIM=8, DPRNN_HIDDEN=8, DPRNN_CHUNK=16,
                   DPRNN_BLOCKS=1)
    cfg.update(BATCH_SIZE=4, TRAIN_STEPS_PER_CALL=2, MESH_DATA=1)
    c.config = cfg
    if c.traffic["kind"] == "train":
        c.traffic = dict(c.traffic, utterance_s=0.5, pool=8, frames=32)
    else:
        c.traffic = dict(c.traffic, min_s=0.3, max_s=1.0, pool=4,
                         check_sample=4)
    c.seed, c.seconds = seed, 0.5
    return c
