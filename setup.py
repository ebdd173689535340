"""PASSL-TPU packaging (console scripts mirror the reference's
`passl-train/passl-eval/passl-export`, setup.py:55-61)."""
from setuptools import find_packages, setup

setup(
    name="passl-tpu",
    version="0.1.0",
    description="TPU-native self-supervised vision framework (JAX/XLA/Pallas)",
    packages=find_packages(include=("passl_tpu", "passl_tpu.*", "passl_tpu_torch", "passl_tpu_torch.*")),
    python_requires=">=3.10",
    install_requires=["jax", "flax", "numpy", "pyyaml", "pillow"],
    entry_points={
        "console_scripts": [
            "passl-train = passl_tpu.tools.train:main",
            "passl-eval = passl_tpu.tools.eval:main",
            "passl-export = passl_tpu.tools.export:main",
            "passl-predict = passl_tpu.tools.predict:main",
        ]
    },
)
