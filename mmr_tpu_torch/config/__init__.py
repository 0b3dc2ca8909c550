from mmr_tpu_torch.config.config import (  # noqa: F401
    add_user_config_args,
    check_and_convert_user_config_args,
    create_config,
    dump_yaml,
    get_config,
    get_default_config,
    load_yaml,
    read_config,
    safe_eval,
)
