from setuptools import find_packages, setup

setup(
    name="circom-tpu",
    version="0.1.0",
    description="TPU-native circom compiler and batched witness generator",
    packages=find_packages(include=["circom_tpu", "circom_tpu.*",
                                    "circom_tpu_torch",
                                    "circom_tpu_torch.*"]),
    python_requires=">=3.10",
    entry_points={
        "console_scripts": ["circom-tpu=circom_tpu.cli:main"],
    },
)
