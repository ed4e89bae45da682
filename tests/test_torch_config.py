"""The port's own parsers against the JAX package's: the same flags, dests
and defaults, and the same parse of a launch script's argv (exact)."""

import pytest

from ddpm_ood_tpu import config as jax_config
from ddpm_ood_tpu_torch import config

ARGVS = {
    "parse_args_train_ddpm": [
        "--output_dir=out", "--model_name=m", "--training_ids=a.csv", "--validation_ids=b.csv",
        "--image_size=32", "--image_roi=(160,160,-1)", "--latent_pad=(0,0,1,1)",
        "--prediction_type=v_prediction", "--model_type=big", "--beta_schedule=cosine_beta",
        "--beta_start=0.001", "--beta_end=0.03", "--b_scale=2", "--snr_shift=0.5",
        "--batch_size=16", "--ema_decay=0.999", "--grad_accum_steps=4", "--learning_rate=1e-4",
        "--lr_warmup_steps=100", "--n_epochs=3", "--eval_freq=1", "--augmentation=0",
        "--num_workers=2", "--cache_data=0", "--checkpoint_every=1",
        "--ddpm_checkpoint_epoch=2", "--is_grayscale=1", "--quick_test=1",
    ],
    "parse_args_train_vqvae": [
        "--output_dir=out", "--model_name=m", "--training_ids=a.csv", "--validation_ids=b.csv",
        "--image_size=128", "--image_roi=[160,160,128]", "--spatial_dimension=3",
        "--vqvae_downsample_parameters=[[2,4,1,1],[2,4,1,1],[2,4,1,1],[2,4,1,1]]",
        "--vqvae_upsample_parameters=[[2,4,1,1,0],[2,4,1,1,0],[2,4,1,1,0],[2,4,1,1,0]]",
        "--vqvae_num_channels=[256,256,256,256]", "--vqvae_num_res_channels=[256,256,256,256]",
        "--vqvae_embedding_dim=128", "--vqvae_num_embeddings=2048", "--vqvae_decay=0.9",
        "--vqvae_learning_rate=3e-5", "--remat=1", "--grad_accum_steps=4", "--batch_size=8",
        "--n_epochs=300", "--eval_freq=10", "--cache_data=0", "--adversarial_warmup=1",
        "--is_grayscale=1", "--quick_test=1",
    ],
    "parse_args_reconstruct": [
        "--output_dir=out", "--model_name=m", "--validation_ids=v.csv", "--in_ids=i.csv",
        "--out_ids=o.csv,i.csv_vflip", "--image_size=32", "--batch_size=8",
        "--num_inference_steps=50", "--inference_skip_factor=2", "--eval_checkpoint=4",
        "--first_n=3", "--first_n_val=2", "--run_out=0", "--use_ema=1", "--recon_groups=4",
    ],
}


@pytest.mark.parametrize("fn", sorted(ARGVS))
def test_defaults_and_dests_match_jax(fn):
    assert vars(getattr(config, fn)([])) == vars(getattr(jax_config, fn)([]))


@pytest.mark.parametrize("fn", sorted(ARGVS))
def test_launch_argv_parses_like_jax(fn):
    got = vars(getattr(config, fn)(ARGVS[fn]))
    assert got == vars(getattr(jax_config, fn)(ARGVS[fn]))
    assert got != vars(getattr(config, fn)([]))


@pytest.mark.parametrize("fn", sorted(ARGVS))
def test_unknown_flag_is_refused_like_jax(fn):
    for parse in (getattr(config, fn), getattr(jax_config, fn)):
        with pytest.raises(SystemExit):
            parse(["--no_such_flag=1"])
