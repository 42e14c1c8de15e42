"""The downstream toolkit (bubble calling, the presence/absence matrix and
the other pangene.js subcommands): host code with no device work, run as
``python -m pangene_tpu_torch.tools.cli <command> ...``."""
