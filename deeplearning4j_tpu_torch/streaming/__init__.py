"""Record conversion (counterpart: ``deeplearning4j_tpu/streaming/``): only
the base64 record decoder ``/predict`` reads. The Kafka-style streaming
routes wait for the fleet slice."""
